"""The port's auxiliary entry points on the CPU: the program's spans, phase
timing and the fusion CLI's ``--profile`` (``utils/profiling.py``), the
kernel classifier, the mask overlay and LabelMe
export (``segmentation/viz.py``) and the demo (``cli/app.py``), and the
W8A8 calibration tool (``tools/calibrate_quant.py``), against the JAX
package where it has a counterpart.

Tolerances: ``draw_image`` 1e-6 (atol, fp32 blending); contours and
LabelMe dicts exact (integer pixel coordinates, against the JAX package's
``cv2.findContours``); calibration tables 1e-5 relative.
"""

import json
import os
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.segmentation import viz as jax_viz
from tweediemix_tpu_torch.cli import app, fusion_sampling
from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models import vae as port_vae
from tweediemix_tpu_torch.models.convert import load_params
from tweediemix_tpu_torch.ops import quant as port_quant
from tweediemix_tpu_torch.segmentation import viz as port_viz
from tweediemix_tpu_torch.tools import calibrate_quant as port_cal
from tweediemix_tpu_torch.utils import profiling
from tweediemix_tpu_torch.utils.image import write_png

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- profiling ------------------------------------------------------------------------


def _tiny_fusion(quant=None):
    n = 3
    fcfg = port_sampler.FusionConfig(n_timesteps=4, t_cond=0.5, resampling_steps=1,
                                     jumping_steps=1, height=64, width=64, num_concepts=n)
    torch.manual_seed(0)
    pipe = TweedieMixPipeline.from_random_weights(
        port_unet2d.UNetConfig.tiny(concept_slots=n + 1, quant=quant), port_vae.VAEConfig.tiny(),
        fcfg, device="cpu")

    def rows(m):
        return 0.2 * torch.randn(m, 6, 32), 0.2 * torch.randn(m, 32)

    embeds = port_sampler.TextEmbeds(*rows(2), *rows(n - 1), *rows(n + 1))
    fg = torch.zeros(n - 1, 64, 64)
    fg[0, :, :29] = 1.0
    fg[1, :, 29:] = 1.0
    return pipe, embeds, fg


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def tracer():
    profiling.TRACER.clear()
    yield profiling.TRACER
    profiling.TRACER.clear()


def test_phase_timer(tracer):
    """``phase`` times each block into its dict on the host clock; a span
    of the phase's name only while the profiler records."""
    secs = {}
    with profiling.phase(secs, "a", torch.device("cpu")):
        time.sleep(0.002)
    assert set(secs) == {"a"} and secs["a"] >= 0.002 and not tracer.spans
    with _cpu_profile():
        with profiling.phase(secs, "b", torch.device("cpu")):
            pass
    assert set(secs) == {"a", "b"}
    assert [s["name"] for s in profiling.spans()] == ["b"]


def test_no_profiler_no_span_no_range_and_todays_phase_keys(tracer, monkeypatch):
    """Without a profiler a span is the shared no-op object: a whole W8A8
    sample opens no record_function and reads no span clock."""
    pipe, embeds, fg = _tiny_fusion(quant="int8")

    def forbidden(*a, **k):
        raise AssertionError("opened while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(profiling.time, "time_ns", forbidden)
    assert profiling.span("unet", rows=2) is profiling.span("w8a8.site")
    pipe.sample(embeds, fg_masks=fg)
    assert not tracer.spans and tracer.dropped == 0
    assert set(pipe.phase_seconds) == {"prologue", "joint", "jumping", "fused", "decode"}
    assert all(v >= 0 for v in pipe.phase_seconds.values())


def test_spans_nest_request_phase_step_unet_block_site(tracer):
    pipe, embeds, fg = _tiny_fusion(quant="int8")
    with _cpu_profile():
        pipe.sample(embeds, fg_masks=fg, seed=3)
    spans = profiling.spans()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names[0] == "request" and spans[0]["attrs"] == {"seed": 3, "rows": 1}
    assert {s["request"] for s in spans} == {spans[0]["id"]}
    phases = [s["name"] for s in spans if s["parent"] == spans[0]["id"]]
    assert phases == ["prologue", "joint", "jumping", "fused", "decode"]
    steps = [s for s in spans if s["name"] == "fusion.step"]
    unets = [s for s in spans if s["name"] == "unet"]
    # prologue, one resampling call and the prologue again; 1 joint, 1 jumping, 2 fused
    assert [s["attrs"]["phase"] for s in steps] == [
        "prologue", "resampling", "prologue", "joint", "jumping", "fused", "fused"]
    assert [s["attrs"]["rows"] for s in steps] == [4, 2, 4, 2, 2, 4, 4]
    assert [by_id[u["parent"]]["name"] for u in unets] == ["fusion.step"] * len(steps)
    assert [u["attrs"]["rows"] for u in unets] == [s["attrs"]["rows"] for s in steps]
    for u in unets:
        kids = [s["name"] for s in spans if s["parent"] == u["id"]]
        assert kids == ["unet.embed", "unet.down.0", "unet.down.1", "unet.mid", "unet.up.0",
                        "unet.up.1"]
    sites = [s for s in spans if s["name"] == "w8a8.site"]
    assert sites and len(sites) % len(unets) == 0
    assert all(by_id[s["parent"]]["name"].startswith("unet.") for s in sites)
    assert {s["attrs"]["scale"] for s in sites} == {"dynamic"}
    assert all(s["attrs"]["m"] > 0 and s["attrs"]["k"] > 0 and s["attrs"]["n"] > 0 for s in sites)
    for s in spans:  # each inside its parent
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    assert all(s["syncs"] == 0 for s in spans)  # no card: no synchronising CUDA operation


def test_each_span_is_a_profiler_range_on_the_profilers_clock(tracer):
    pipe, embeds, fg = _tiny_fusion()
    with _cpu_profile() as prof:
        pipe.sample(embeds, fg_masks=fg)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(e.start_ns())
    seen = {}
    for s in profiling.spans():
        i = seen[s["name"]] = seen.get(s["name"], -1) + 1
        starts = sorted(ranges[s["name"]])
        assert len(starts) == sum(t["name"] == s["name"] for t in profiling.spans())
        assert abs(starts[i] - s["start_ns"]) < 1_000_000, s["name"]
        assert "::" not in s["name"] and not s["name"].startswith("cuda")


def test_the_cap_drops_the_oldest_spans_and_counts_them(monkeypatch):
    cut = profiling.Tracer(cap=3)
    monkeypatch.setattr(profiling, "TRACER", cut)
    with _cpu_profile():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
    assert [s["attrs"]["i"] for s in profiling.spans()] == [2, 3, 4]
    assert cut.dropped == 2


def test_sync_count_goes_into_every_open_span_and_the_filters_come_back(tracer):
    filters, show = list(warnings.filters), warnings.showwarning
    other = []
    warnings.showwarning = lambda *a, **k: other.append(str(a[0]))
    try:
        with _cpu_profile():
            with profiling.span("outer"):
                assert warnings.showwarning == tracer.on_warning
                warnings.warn(profiling.SYNC_WARNING + " (a stand-in)")
                with profiling.span("inner"):
                    for _ in range(2):  # the same line twice: counted each time
                        warnings.warn(profiling.SYNC_WARNING + " (a stand-in)")
                    warnings.warn("something else")
            inner_show = warnings.showwarning
    finally:
        shown, warnings.showwarning = warnings.showwarning, show
    assert inner_show is shown and other == ["something else"]
    assert warnings.filters == filters
    assert {s["name"]: s["syncs"] for s in profiling.spans()} == {"outer": 3, "inner": 2}


def test_cli_profile_writes_phase_timings_and_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    out = tmp_path / "out"
    assert fusion_sampling.main([
        "--model_preset", "tiny", "--prompt", "photo of a cat+photo of a dog+mountain background",
        "--prompt_orig", "a cat and a dog", "--concepts", "cat+dog+mountain",
        "--modifier_token", "<cat1>+<dog1>+<mountain1>", "--seg_concepts", "a cat+a dog",
        "--seg_preset", "heuristic", "--output_path", str(out), "--n_timesteps", "4",
        "--t_cond", "0.5", "--resampling_steps", "0", "--jumping_steps", "1",
        "--resolution_h", "64", "--resolution_w", "64", "--num_seeds", "2",
        "--profile", str(prof)], device="cpu") == 0
    timings = json.loads((prof / "phase_timings.json").read_text())
    assert set(timings) == {"sample_2_seeds"} and timings["sample_2_seeds"] > 0
    with open(prof / profiling.TRACE_FILE) as f:
        chrome = json.load(f)
    names = {e.get("name") for e in chrome["traceEvents"]}
    assert {"request", "fused", "fusion.step", "unet", "unet.mid"} <= names  # the spans' ranges
    assert any(str(n).startswith("aten::") for n in names)
    assert profiling.chrome_trace_kernels(str(prof / profiling.TRACE_FILE)) == []  # no card
    kept = json.loads((prof / profiling.SPANS_FILE).read_text())
    assert kept["baseTimeNanoseconds"] == chrome["baseTimeNanoseconds"] and kept["dropped"] == 0
    request = [s for s in kept["spans"] if s["name"] == "request"]
    assert len(request) == 1 and request[0]["attrs"] == {"seed": 182, "rows": 2}
    assert timings["sample_2_seeds"] == pytest.approx(
        (request[0]["end_ns"] - request[0]["start_ns"]) * 1e-9)
    # the request span lines up with its range in the trace (ts: µs after the base)
    ts = next(e["ts"] for e in chrome["traceEvents"] if e.get("name") == "request")
    assert abs(ts - (request[0]["start_ns"] - kept["baseTimeNanoseconds"]) / 1e3) < 1000
    assert len(list(out.glob("*.png"))) == 2
    assert "saved" in capsys.readouterr().out


def test_kernel_classes_and_device_breakdown(tmp_path):
    """One classifier for the card's kernel names, fed from a Chrome trace."""
    names = {
        "void flash_fwd_kernel<Cfg<64, 128>, false>(CUtensorMap, CUtensorMap)": "flash_attention",
        "void (anonymous namespace)::flash_int8_wgmma_kernel<64>(...)": "flash_attention_int8",
        "void short_attn_kernel<64>(...)": "short_attention",
        "nvjet_hsh_128x256_64x4_2x1_v_bz_coopB_NNN": "gemm",
        "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise/copy",
        "cutlass_80_wmma_tensorop_s161616gemm_bf16": "gemm",
        "RowwiseMomentsCUDAKernel": "norm",
        "mystery": "other",
    }
    for name, cls in names.items():
        assert profiling.kernel_class(name) == cls, name
    # eight 10 µs kernels, the last two overlapping the two before by half
    starts = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0, 45.0, 55.0]
    trace = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": 10.0}
                             for n, t in zip(names, starts)]
             + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 99.0}]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    kernels = profiling.chrome_trace_kernels(str(path))
    assert len(kernels) == len(names)
    out = profiling.device_breakdown(kernels, wall_ms=0.13)
    assert out["by_class_count"]["gemm"] == 2 and out["by_class_count"]["flash_attention"] == 1
    assert out["device_busy_ms"] == pytest.approx(0.065)  # the union of the intervals: 0-65 µs
    assert out["device_idle_share"] == pytest.approx(0.5)
    assert out["by_class_ms"]["gemm"] == pytest.approx(0.02)


# -- viz and the demo -------------------------------------------------------------------


def _masks(case):
    m = np.zeros((64, 80), np.uint8)
    if case == "rectangles":
        m[5:20, 10:40] = 1
        m[30:60, 50:75] = 1
    elif case == "l_shape":
        m[10:50, 10:25] = 1
        m[35:50, 10:60] = 1
    elif case == "ring_with_hole":
        yy, xx = np.mgrid[:64, :80]
        d = np.hypot(yy - 32, xx - 40)
        m[(d < 25) & (d >= 12)] = 1
        m[28:36, 36:44] = 1  # an island in the hole (not external)
    elif case == "blobs":
        yy, xx = np.mgrid[:64, :80]
        for cy, cx, r in ((15, 15, 9), (40, 60, 12), (50, 20, 7), (12, 55, 6)):
            m[np.hypot(yy - cy, xx - cx) < r] = 1
    elif case == "touching_the_border":
        m[:20, :30] = 1
        m[40:, 60:] = 1
        m[25:40, :] = 1
    elif case == "speck":
        m[10:14, 10:14] = 1  # area 9 < MIN_AREA
        m[30:50, 30:60] = 1
    elif case == "noise":
        from scipy.ndimage import gaussian_filter

        m = (gaussian_filter(np.random.default_rng(3).random((64, 80)), 2.0) > 0.5).astype(np.uint8)
    return m


MASK_CASES = ["rectangles", "l_shape", "ring_with_hole", "blobs", "touching_the_border", "speck",
              "noise"]


@pytest.mark.parametrize("case", MASK_CASES)
def test_mask_contours_match_cv2(case):
    m = _masks(case).astype(np.float32)
    want = jax_viz.mask_contours(m)
    got = port_viz.mask_contours(m)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # every border, kept or not, and its area as cv2 gives them
    import cv2

    raw, _ = cv2.findContours(_masks(case) * 255, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    ours = port_viz._external_borders(_masks(case) > 0)
    assert [c.reshape(-1, 2).tolist() for c in raw] == [c.tolist() for c in ours]
    assert [cv2.contourArea(c) for c in raw] == [port_viz.contour_area(c) for c in ours]


def test_generate_labelme_json_matches_jax():
    masks = np.stack([_masks(c) for c in ("rectangles", "ring_with_hole", "speck", "blobs")])
    labels = ["a cat", "a dog", "a speck", "stones"]
    want = jax_viz.generate_labelme_json(masks, labels, (64, 80), "img.png")
    got = port_viz.generate_labelme_json(masks, labels, (64, 80), "img.png")
    assert json.dumps(got) == json.dumps(want)
    assert [s["label"] for s in got["shapes"]].count("a speck") == 1


def test_draw_image_matches_jax():
    rng = np.random.default_rng(4)
    image = rng.random((48, 64, 3)).astype(np.float32)
    masks = rng.random((9, 48, 64)) > 0.6
    boxes = np.sort(rng.random((9, 4)), axis=-1)[:, [0, 2, 1, 3]]
    want = jax_viz.draw_image(image, masks, boxes)
    got = port_viz.draw_image(image, masks, boxes)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port_viz.draw_image(image, masks[:0]), image)


def test_load_image_reads_a_png_in_unit_range(tmp_path):
    pixels = np.random.default_rng(5).integers(0, 256, (10, 12, 3), dtype=np.uint8)
    write_png(str(tmp_path / "x.png"), pixels)
    got = port_viz.load_image(str(tmp_path / "x.png"))
    np.testing.assert_array_equal(got, jax_viz.load_image(str(tmp_path / "x.png")))
    assert got.dtype == np.float32 and got.max() <= 1.0


def test_app_predict_fn_runs_headless_on_cpu():
    predict = app.make_predict_fn("sam-random", device="cpu")
    image = np.random.default_rng(6).random((40, 48, 3)).astype(np.float32)
    out = predict(image, "a cat", box_threshold=0.0)
    masks, boxes, _, valid = predict.lang_sam.predict(torch.from_numpy(image), "a cat",
                                                      box_threshold=0.0)
    keep = valid.numpy()
    assert keep.any()
    want = port_viz.draw_image(image, masks.float().numpy()[keep], boxes.numpy()[keep])
    assert out.shape == image.shape and np.array_equal(out, want)
    with pytest.raises(ValueError, match="preset"):
        app.make_predict_fn("owl", device="cpu")


def test_app_main_without_gradio_returns_1(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert app.main(["--preset", "sam-random"], device="cpu") == 1
    assert "gradio is not installed" in capsys.readouterr().err


# -- the W8A8 calibration tool ------------------------------------------------------------


def _jax_calibrate():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from calibrate_quant import calibrate
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return calibrate


def test_calibration_tool_matches_the_jax_tool(monkeypatch):
    """The JAX tool's ``calibrate`` and the port tool's ``calibrate_unet``
    on one numpy-seeded micro tree (weights 0.02 · N(0, 1), as both tools
    draw them) and the port tool's probes: the same site keys, and values
    within 1e-5 relative."""
    b = port_cal.N_CONCEPTS + 1
    jcfg = jax_unet2d.UNetConfig.micro(concept_slots=b, quant="int8")
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    x, ctx, pooled, tids, idx = port_cal.probe_inputs(b, 8, 16, jcfg.cross_attention_dim,
                                                      jcfg.pooled_projection_dim, seed=0)
    idx32 = idx.astype(np.int32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.int32(1), ctx, pooled,
                              tids, idx32)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (port_cal.WEIGHT_STD * rng.standard_normal(s.shape)).astype(np.float32), abstract)
    monkeypatch.setenv("TWEEDIEMIX_QUANT_CALIBRATE", "1")
    want = _jax_calibrate()(model, params, [(x, jnp.int32(t), ctx, pooled, tids, idx32)
                                            for t in port_cal.PROBE_TIMESTEPS], margin=1.25)
    monkeypatch.delenv("TWEEDIEMIX_QUANT_CALIBRATE")
    port = port_unet2d.UNet2DConditionModel(
        port_unet2d.UNetConfig.micro(concept_slots=b, quant="int8"), device="cpu")
    load_params(port, params)
    got = port_cal.calibrate_unet(port, (x, ctx, pooled, tids, idx), margin=1.25)
    assert set(got) == set(want) == set(port_quant.quant_sites(port))
    for site in want:
        assert got[site] == pytest.approx(want[site], rel=1e-5), site


def test_calibration_tool_main_writes_a_table_the_unet_loads(tmp_path, capsys):
    out = tmp_path / "scales.json"
    assert port_cal.main(["--micro", "--out", str(out), "--margin", "2.0"], device="cpu") == 0
    table = json.loads(out.read_text())
    ucfg = port_unet2d.UNetConfig.micro(concept_slots=port_cal.N_CONCEPTS + 1, quant="int8")
    unet = port_unet2d.UNet2DConditionModel(ucfg, device="cpu")
    assert port_quant.load_static_scales(unet, str(out)) == len(table) == len(
        port_quant.quant_sites(unet))
    assert all(v > 0 for v in table.values())
    assert f"calibrated {len(table)} sites" in capsys.readouterr().out
    # seeded: the weights and probes are drawn again the same way
    again = port_cal.calibrate_unet(port_cal.random_unet(ucfg, 0, "cpu"),
                                    port_cal.probe_inputs(4, 8, 16, ucfg.cross_attention_dim,
                                                          ucfg.pooled_projection_dim, 0), 2.0)
    assert again == pytest.approx(table, rel=1e-6)
