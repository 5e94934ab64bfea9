"""The reader of ``unet_graph_replay_pct.image`` on a fabricated span store:
the share of the first pass's ``unet`` spans whose ``graph`` attribute is
``"replay"``, 0 where the spans carry no such attribute, nothing read where
the program keeps no spans."""

import pytest

from benchmark import harness
from benchmark.tests.test_bench_program_spans import ctx, store
from tweediemix_tpu_torch.utils import profiling

METRIC = "unet_graph_replay_pct.image"


def with_graph(spans, graphs):
    """``spans`` with the n-th ``unet`` span's attributes given
    ``graph=graphs[n]`` (both passes)."""
    unets = iter(graphs)
    return [dict(s, attrs=dict(s["attrs"], graph=next(unets))) if s["name"] == "unet" else s
            for s in spans]


@pytest.fixture
def fake(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    return put


@pytest.mark.parametrize("graphs,share", [
    (["replay"] * 4, 100.0),
    (["capture", "replay", "replay", "replay"], 50.0),  # the first pass: capture, replay
    (["eager"] * 4, 0.0),
])
def test_the_share_of_replayed_calls_in_the_first_pass(fake, graphs, share):
    fake(with_graph(store(), graphs))
    assert harness.read_metric(METRIC, ctx()) == pytest.approx(share)


def test_spans_without_the_attribute_read_zero(fake):
    fake(store())
    assert harness.read_metric(METRIC, ctx()) == 0.0


def test_nothing_is_read_without_spans(fake, monkeypatch):
    fake([])
    assert harness.read_metric(METRIC, ctx()) is None
    fake(with_graph(store(passes=1), ["replay"] * 2))
    assert harness.read_metric(METRIC, ctx()) is None
    monkeypatch.delattr(profiling, "spans")
    assert harness.read_metric(METRIC, ctx()) is None
