"""The fusion pipeline's UNet call through CUDA graphs
(``models/unet_graph.py``), without JAX.

On the CPU: the runner runs its body eagerly (on the CPU and under
autograd; a mesh replica's call takes its forward) and equals the
forward, its ``unet`` span says ``graph="eager"``, it captures nothing and
touches no kernel counter; its body is the forward with the K/V of
``precompute_cross_kv``, which under W8A8 is not the in-module projection;
``_unet_fn`` builds ``time_ids`` once per (device, rows); the graph key
holds every knob of ``ops/attention.py``, every counted wrapper names a
kernel of ``csrc/``, and the kernel names a graph's nodes give are counted
by that name.

On the card (``cuda`` marker, skipped elsewhere), a small SDXL-shaped UNet
(stacked concept K/V, dh 64, the level of 256 tokens routed to the flash
kernel by ``TWEEDIEMIX_FLASH_MIN_S``), in bf16 and in W8A8 with the int8
attention core: a capture and every replay equal the eager forward with its
K/V cache bit for bit at 2 and 4 rows on a prologue-like sequence whose
inputs all change; two consecutive outputs of one key both stay intact; a
replay adds to each launch counter what one eager call adds, and the
census of a captured graph through libcuda counts the kernel nodes it holds; a
replay synchronises with the host nowhere
(``torch.cuda.set_sync_debug_mode("error")``); and a tiny sample through the
graphs equals the same sample run eagerly.

This file imports torch and the port only, so it also runs on the GPU
machine: ``python -m pytest --noconftest tests/test_torch_port_unet_graph.py -m cuda``.
"""

import inspect
import os
import re

import pytest
import torch

from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig, precompute_cross_kv
from tweediemix_tpu_torch.models.unet_graph import UNetGraphs, graph_kernel_names, kernel_launches
from tweediemix_tpu_torch.ops import attention, cuda_build
from tweediemix_tpu_torch.ops.flash_attention import flash_attention
from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tweediemix_tpu_torch.utils import profiling

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N = 3  # concepts with the background: 4 rows in the prologue and fused calls, 2 in joint ones


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")


def _launches():
    return [fn.launches for fn in cuda_build.LAUNCH_COUNTERS.values()]


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.fixture
def tracer():
    profiling.TRACER.clear()
    yield profiling.TRACER
    profiling.TRACER.clear()


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


# -- the CPU: the eager forward, unchanged ------------------------------------------


def _tiny_pipeline():
    fcfg = port_sampler.FusionConfig(n_timesteps=4, t_cond=0.5, resampling_steps=1,
                                     jumping_steps=1, height=64, width=64, num_concepts=N)
    torch.manual_seed(0)
    return TweedieMixPipeline.from_random_weights(
        UNetConfig.tiny(concept_slots=N + 1), VAEConfig.tiny(), fcfg, device="cpu")


def _tiny_rows(pipe, rows, seed):
    gen = torch.Generator().manual_seed(seed)
    h, w = pipe.fusion_config.latent_hw
    return (torch.randn((rows, h, w, 4), generator=gen), torch.randn((rows, 6, 32), generator=gen),
            torch.randn((rows, 32), generator=gen), torch.arange(rows) % (N + 1))


def test_the_runner_is_the_eager_forward_on_the_cpu_under_grad_and_for_a_mesh_replica(tracer):
    pipe = _tiny_pipeline()
    x, ctx, pooled, idx = _tiny_rows(pipe, N + 1, 1)
    time_ids = pipe._time_ids(N + 1, x.device)
    before = _launches()
    with _cpu_profile():
        with torch.inference_mode():
            got = pipe._unet_fn(x, 501, ctx, pooled, idx)
        with torch.enable_grad():
            pipe._unet_fn(x, 501, ctx, pooled, idx)
        with torch.inference_mode():
            meshed = pipe.sampler_for(2).unet_fn(x, 501, ctx, pooled, idx)
    with torch.inference_mode():
        want = pipe.unet(x, 501, ctx, pooled, time_ids, idx)
    assert torch.equal(got, want) and _rel_l2(meshed, want) <= 1e-5
    unets = [s for s in profiling.spans() if s["name"] == "unet"]
    # one call, one under grad, the mesh's two halves
    assert [u["attrs"] for u in unets] == [dict(rows=4, graph="eager")] * 2 + [
        dict(rows=2, graph="eager")] * 2
    assert _launches() == before
    g = pipe.unet_graphs
    assert (g.graphs, g.captures, g.replays) == ({}, 0, 0)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["float", "w8a8"])
def test_the_runner_runs_one_body_eager_and_captured(quant):
    """Eager, the runner computes what it captures on a card: the forward
    with the K/V of ``precompute_cross_kv``, which projects a non-stacked
    K/V in float even under W8A8, where the modules' own projection
    quantises it."""
    torch.manual_seed(0)
    unet = UNet2DConditionModel(UNetConfig.micro(quant=quant), device="cpu").eval()
    gen = torch.Generator().manual_seed(4)
    x, ctx = torch.randn((2, 8, 8, 4), generator=gen), torch.randn((2, 5, 32), generator=gen)
    pooled, idx = torch.randn((2, 32), generator=gen), torch.zeros(2, dtype=torch.long)
    time_ids = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]).expand(2, 6)
    with torch.inference_mode():
        got = UNetGraphs(unet)(x, 501, ctx, pooled, time_ids, idx)
        body = unet(x, 501, ctx, pooled, time_ids, idx,
                    cross_kv=precompute_cross_kv(unet, ctx, idx))
        in_module = unet(x, 501, ctx, pooled, time_ids, idx)
    assert torch.equal(got, body)
    if quant:
        assert _rel_l2(in_module, body) > 1e-4
    else:
        assert _rel_l2(in_module, body) <= 1e-6


@pytest.mark.parametrize("grad,card,engaged", [
    (False, True, True), (True, True, False), (False, False, False), (True, False, False)])
def test_the_graphs_engage_on_a_card_with_autograd_off(grad, card, engaged):
    class Input:
        is_cuda = card

    with torch.set_grad_enabled(grad):
        assert UNetGraphs.engages(Input()) is engaged


def test_unet_fn_builds_time_ids_once_per_key():
    pipe = _tiny_pipeline()
    seen = []

    def runner(x, t, ctx, pooled, time_ids, idx):
        seen.append(time_ids)
        return torch.zeros_like(x)

    pipe.unet_graphs = runner
    for i, rows in enumerate((4, 2, 4, 2, 2)):
        x, ctx, pooled, idx = _tiny_rows(pipe, rows, i)
        pipe._unet_fn(x, 501, ctx, pooled, idx)
    assert seen[0] is seen[2] and seen[1] is seen[3] is seen[4] and seen[0] is not seen[1]
    assert len(pipe._time_ids_by_key) == 2
    assert seen[0].tolist() == [[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]] * 4
    assert tuple(seen[1].shape) == (2, 6)


def test_the_graph_key_holds_every_knob_of_the_attention_dispatch(monkeypatch):
    read = set(re.findall(r'"(TWEEDIEMIX_[A-Z0-9_]+)"', inspect.getsource(attention)))
    assert read == set(attention.KNOBS)
    for knob in attention.KNOBS:
        before = attention.dispatch_key()
        monkeypatch.setenv(knob, "7")
        assert attention.dispatch_key() != before


def test_every_counted_wrapper_names_a_kernel_of_its_sources():
    from tweediemix_tpu_torch.ops import quant, short_attention  # noqa: F401  (they register)

    sources = "".join(p.read_text() for p in sorted(cuda_build.CSRC_DIR.glob("*.cu")))
    kernels = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)", sources))
    counters = cuda_build.LAUNCH_COUNTERS.values()
    assert {fn.__name__: fn.kernel for fn in counters} == {
        "flash_attention": "flash_fwd_kernel", "flash_attention_int8": "flash_int8_wgmma_kernel",
        "quantize_qkv_int8_fused": "quantize_kernel", "w8a8_matmul_cuda": "w8a8_int8_gemm_kernel",
        "short_seq_attention": "short_attn_kernel", "group_norm": "group_norm_kernel"}
    assert {fn.kernel for fn in counters} <= kernels


@pytest.mark.parametrize("kernel,count", [
    ("flash_fwd_kernel", 2), ("quantize_kernel", 1), ("w8a8_int8_quant_kernel", 1),
    ("flash_int8_wgmma_kernel", 0), ("absmax_kernel", 0), ("group_norm_kernel", 2)])
def test_kernel_launches_counts_nodes_by_the_kernels_source_name(kernel, count):
    names = ["_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iif",
             "(anonymous namespace)::flash_fwd_kernel<128, false>(CUtensorMap_st)",
             "_ZN12_GLOBAL__N_115quantize_kernelILi64EEvPK5uint4S3_PK13__nv_bfloat16P5uint2",
             "_ZN12_GLOBAL__N_122w8a8_int8_quant_kernelI13__nv_bfloat16EEvPKT_PaPffii",
             "_ZN12_GLOBAL__N_120absmax_kernel_sharedEv",
             "_ZN12_GLOBAL__N_117group_norm_kernelI13__nv_bfloat16Li8ELb1EEEvNS_6ParamsE",
             "void (anonymous namespace)::group_norm_kernel<float, 1, false>(Params)",
             "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>",
             "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", ""]
    assert kernel_launches(names, kernel) == count


# -- the card ---------------------------------------------------------------------------


def _card_unet(quant):
    """SDXL's topology at two levels of 64 and 128 channels, heads 64 wide,
    stacked K/V for four concept slots, bf16; on a 32x32 latent the
    self-attention runs over 256 tokens."""
    cfg = UNetConfig.tiny(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                          cross_attention_dim=64, pooled_projection_dim=32,
                          concept_slots=N + 1, quant=quant, dtype=torch.bfloat16)
    torch.manual_seed(0)
    return UNet2DConditionModel(cfg, device="cuda").eval()


def _card_inputs(rows, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, 32, 32, 4), generator=gen, device="cuda")
    ctx = torch.randn((rows, 77, 64), generator=gen, device="cuda")
    pooled = torch.randn((rows, 32), generator=gen, device="cuda")
    idx = torch.randint(0, N + 1, (rows,), generator=gen, device="cuda")
    time_ids = torch.tensor([[256.0, 256.0, 0.0, 0.0, 256.0, 256.0]], device="cuda").expand(rows, 6)
    return x, ctx, pooled, time_ids, idx


@pytest.fixture(params=[None, "int8"], ids=["bf16", "w8a8"])
def card_unet(request, monkeypatch):
    _card()
    monkeypatch.setenv("TWEEDIEMIX_FLASH_MIN_S", "256")
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "1" if request.param else "0")
    return _card_unet(request.param)


# (rows, t) of a prologue-like sequence: the batch-(N+1) call, a joint call, again
SEQUENCE = [(4, 981), (2, 961), (4, 981), (2, 961), (4, 941), (2, 921)]


def _eager(unet, t, inputs):
    x, ctx, pooled, time_ids, idx = inputs
    return unet(x, t, ctx, pooled, time_ids, idx, cross_kv=precompute_cross_kv(unet, ctx, idx))


@pytest.mark.cuda
def test_replays_hold_to_the_eager_forward_on_a_prologue_like_sequence(card_unet):
    runner = UNetGraphs(card_unet)
    with torch.inference_mode():
        for i, (rows, t) in enumerate(SEQUENCE):
            inputs = _card_inputs(rows, i)
            got = runner(inputs[0], t, *inputs[1:])
            want = _eager(card_unet, t, inputs)
            torch.cuda.synchronize()
            # a capture's own call is the eager body, a replay the same kernels on the same inputs
            assert torch.equal(got, want), (i, rows, t, _rel_l2(got, want))
    assert (runner.captures, runner.replays, len(runner.graphs)) == (2, 4, 2)


@pytest.mark.cuda
def test_two_outputs_of_one_key_both_stay_intact(card_unet):
    runner = UNetGraphs(card_unet)
    with torch.inference_mode():
        first_in, second_in, third_in = (_card_inputs(4, s) for s in (10, 11, 12))
        runner(first_in[0], 501, *first_in[1:])  # the capture
        a = runner(second_in[0], 501, *second_in[1:])
        a_kept = a.clone()
        b = runner(third_in[0], 301, *third_in[1:])
        torch.cuda.synchronize()
    assert torch.equal(a, a_kept) and not torch.equal(a, b)
    assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
def test_a_replay_counts_the_launches_of_one_eager_call(card_unet):
    runner = UNetGraphs(card_unet)
    inputs = _card_inputs(4, 20)
    with torch.inference_mode():
        before = _launches()
        _eager(card_unet, 501, inputs)
        eager = [a - b for a, b in zip(_launches(), before)]
        before = _launches()
        runner(inputs[0], 501, *inputs[1:])  # the capture: its eager call counts, the capture not
        capture = [a - b for a, b in zip(_launches(), before)]
        before = _launches()
        runner(inputs[0], 401, *inputs[1:])
        replay = [a - b for a, b in zip(_launches(), before)]
    assert replay == eager == capture
    assert sum(eager) > 0


@pytest.mark.cuda
def test_the_census_counts_the_kernel_nodes_a_graph_holds():
    _card()
    q = torch.randn((2, 1024, 64), dtype=torch.bfloat16, device="cuda")
    flash_attention(q, q, q)  # the kernel's first load, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = flash_attention(q, q, q) + 1
        out = flash_attention(out, q, q)
    graph.instantiate()
    names = graph_kernel_names(graph.raw_cuda_graph())
    assert kernel_launches(names, "flash_fwd_kernel") == 2
    assert len(names) == 3 and kernel_launches(names, "quantize_kernel") == 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_a_replay_makes_no_host_sync(card_unet):
    runner = UNetGraphs(card_unet)
    inputs = _card_inputs(2, 30)
    with torch.inference_mode():
        runner(inputs[0], 501, *inputs[1:])
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = runner(inputs[0], 401, *inputs[1:])
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert out.shape == (2, 32, 32, 4) and torch.isfinite(out).all()


@pytest.mark.cuda
def test_a_sample_through_the_graphs_holds_to_the_eager_sample(monkeypatch, tracer):
    _card()
    monkeypatch.setenv("TWEEDIEMIX_FLASH_MIN_S", "256")
    fcfg = port_sampler.FusionConfig(n_timesteps=6, t_cond=0.5, resampling_steps=2,
                                     jumping_steps=1, height=256, width=256, num_concepts=N)
    unet = _card_unet(None)
    torch.manual_seed(0)
    pipe = TweedieMixPipeline(unet, AutoencoderKL(VAEConfig.tiny(), device="cuda"), fcfg,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rows(m):
        return (torch.randn((m, 77, 64), generator=gen, device="cuda"),
                torch.randn((m, 32), generator=gen, device="cuda"))

    embeds = port_sampler.TextEmbeds(*rows(2), *rows(N - 1), *rows(N + 1))
    fg = torch.zeros((N - 1, 256, 256), device="cuda")
    fg[0, :, :128] = 1.0
    fg[1, :, 128:] = 1.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe.sample(embeds, seed=5, fg_masks=fg)
    graphed = pipe.last_latent.clone()
    graphs = [u["attrs"]["graph"] for u in profiling.spans() if u["name"] == "unet"]
    assert len(graphs) == fcfg.unet_calls()
    assert graphs.count("capture") == 2 and graphs.count("replay") == fcfg.unet_calls() - 2
    monkeypatch.setattr(UNetGraphs, "engages", staticmethod(lambda x: False))
    pipe.sample(embeds, seed=5, fg_masks=fg)
    assert torch.equal(graphed, pipe.last_latent), _rel_l2(graphed, pipe.last_latent)
