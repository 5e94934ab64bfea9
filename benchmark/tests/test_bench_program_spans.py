"""The readers of the port's own spans on a fabricated span store: the
first pass of the traced slice (its first ``unet_calls`` ``unet`` spans
with their ancestors and descendants), and nothing read when the store does
not hold exactly two passes or the program keeps no spans."""

import pytest

from benchmark import harness
from tweediemix_tpu_torch.utils import profiling

MS = 1_000_000


def store(passes=2, calls=2, sites=3, step="fusion.step", syncs=(1, 443)):
    """``passes`` passes of ``calls`` steps, each holding one ``unet`` span
    with a block holding ``sites`` W8A8 sites; in the first pass a call
    lasts 10 ms, a site 0.1 ms, and the steps hold ``syncs[0]`` syncs, in
    the second 30 ms, 0.3 ms and ``syncs[1]``."""
    spans, ids = [], iter(range(1, 10_000))
    t = 0
    for p in range(passes):
        scale = 1 + 2 * p
        for c in range(calls):
            st, un, blk = next(ids), next(ids), next(ids)
            spans.append(dict(name=step, id=st, parent=None, request=st, start_ns=t,
                              end_ns=t + 12 * MS * scale, syncs=syncs[min(p, 1)], attrs={}))
            spans.append(dict(name="unet", id=un, parent=st, request=st, start_ns=t + MS,
                              end_ns=t + MS + 10 * MS * scale, syncs=syncs[min(p, 1)], attrs={}))
            spans.append(dict(name="unet.mid", id=blk, parent=un, request=st, start_ns=t + 2 * MS,
                              end_ns=t + 3 * MS, syncs=syncs[min(p, 1)] - 1, attrs={}))
            for k in range(sites):
                s0 = t + 2 * MS + k * MS // 10
                spans.append(dict(name="w8a8.site", id=next(ids), parent=blk, request=st,
                                  start_ns=s0, end_ns=s0 + scale * MS // 10, syncs=1, attrs={}))
            t += 100 * MS
    return spans


def ctx(calls=2):
    return {"slice": {"unet_calls": calls}}


@pytest.fixture
def fake(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    return put


@pytest.mark.parametrize("sites", [3, 0])  # a W8A8 store, and a bf16 one with no site
def test_the_readers_take_the_first_pass(fake, sites):
    fake(store(sites=sites))
    assert harness.read_metric("host_ms_per_call.image", ctx()) == pytest.approx(10.0)
    assert harness.read_metric("host_ms_per_call.clip", ctx()) == pytest.approx(10.0)
    assert harness.read_metric("host_syncs_per_call.image", ctx()) == pytest.approx(1.0)
    fake(store(step="video.step", syncs=(2, 5)))
    assert harness.read_metric("host_syncs_per_call.clip", ctx()) == pytest.approx(2.0)


def test_the_first_pass_holds_its_calls_their_steps_and_what_is_below(fake):
    from benchmark.program_spans import first_pass

    spans = store(sites=2)
    fake(spans)
    got = first_pass(ctx())
    assert [s["id"] for s in got] == [s["id"] for s in spans[:len(spans) // 2]]


@pytest.mark.parametrize("passes", [1, 3])
def test_nothing_is_read_unless_the_store_holds_two_passes(fake, passes):
    fake(store(passes=passes))
    for name in ("host_ms_per_call.image", "host_syncs_per_call.clip"):
        assert harness.read_metric(name, ctx()) is None
    fake(store())
    assert harness.read_metric("host_ms_per_call.image", ctx(calls=3)) is None
    assert harness.read_metric("host_ms_per_call.image", {"slice": {}}) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for name in ("host_ms_per_call.image", "host_syncs_per_call.image"):
        assert harness.read_metric(name, ctx()) is None
