"""The port's meshes (``parallel/mesh.py``), the meshed fusion sampler and
video loop, the CLIs' ``--mesh_devices`` and the compile cache, on the CPU.

A mesh of n here is ``[cpu] * n``: its shards run one after the other on
one CPU through the same row-sharding code a multi-card mesh runs. The JAX
package's sharded versions run on the conftest's 8 virtual CPU devices.

Tolerances: the mock-UNet trajectories at 1e-6 against the port's
unsharded run (the mock is elementwise, so sharding changes nothing) and
1e-4 against the JAX package's ``seed_sharded_unet_fn`` run (the tests of
``test_torch_port_fusion.py``); the tiny UNet3D clips at 1e-4 of the
output's max against the unsharded run and JAX's ``_sharded_loop`` (a
shard's GEMMs see fewer rows, which changes fp32 sum order); the CLI's
PNGs within one 8-bit level of the unsharded run's, for the same reason.
JAX is imported inside the tests only.
"""

import inspect
import io
import json
import os

import numpy as np
import pytest
import torch

from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.parallel import mesh as port_mesh
from tweediemix_tpu_torch.schedulers import ddim as port_ddim

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

H = W = 16  # mock latent size (image 128²)
N = 3  # concepts, background last
MOCK_TOL = 1e-6
JAX_TOL = 1e-4


def cpu_mesh(n):
    return port_mesh.make_mesh({"dp": n}, devices=["cpu"] * n)


# -- the mesh helpers ----------------------------------------------------------------


@pytest.mark.parametrize("b, n", [(3, 4), (4, 4), (1, 8), (5, 2)])
def test_pad_rows_to_matches_jax(b, n):
    import jax.numpy as jnp

    from tweediemix_tpu.parallel.mesh import pad_rows_to as jax_pad

    x = np.random.default_rng(b).standard_normal((b, 3, 2)).astype(np.float32)
    want, want_b = jax_pad(jnp.asarray(x), n)
    got, got_b = port_mesh.pad_rows_to(torch.from_numpy(x), n)
    assert got_b == want_b == b
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_mesh_repeats_devices_and_checks_sizes():
    mesh = cpu_mesh(2)
    assert mesh.shape == {"dp": 2} and list(mesh.local_shards()) == [0, 1]
    assert mesh.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="3-way"):
        port_mesh.make_mesh({"dp": 3}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="one axis"):
        port_mesh.make_mesh({"dp": 2, "tp": 1}, devices=["cpu"] * 2)
    assert port_mesh.make_mesh(devices=["cpu"] * 4).shape == {"dp": 4}
    assert port_mesh.is_primary_process() and not torch.distributed.is_initialized()


def test_replicate_shares_a_device_and_copies_without_reinitialising():
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    module[1].running_mean.fill_(0.5)
    copies = port_mesh.replicate(cpu_mesh(3), module)
    assert all(c is module for c in copies)  # one replica per distinct device
    meta = port_mesh.replicate(port_mesh.make_mesh(devices=["cpu", "meta", "meta"]), module)
    assert meta[0] is module and meta[1] is meta[2] and meta[1] is not module
    assert all(t.device.type == "meta" for t in meta[1].state_dict().values())
    assert module[0].weight.device.type == "cpu" and module[1].running_mean[0] == 0.5
    # tensors: one copy per device, the values kept
    t = torch.arange(4.0)
    assert [c is t for c in port_mesh.replicate(cpu_mesh(2), {"a": t})[0].values()] == [True]


def test_shard_batch_and_place_global_batch_split_rows_contiguously():
    batch = {"a": torch.arange(8).reshape(4, 2), "b": (torch.arange(4.0),)}
    shards = port_mesh.shard_batch(cpu_mesh(2), batch)
    assert [s["a"].tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert [s["b"][0].tolist() for s in shards] == [[0.0, 1.0], [2.0, 3.0]]
    placed = port_mesh.place_global_batch(cpu_mesh(2), batch)
    assert [s["a"].tolist() for s in placed] == [s["a"].tolist() for s in shards]
    with pytest.raises(ValueError, match="do not divide"):
        port_mesh.shard_batch(cpu_mesh(3), batch)
    x = torch.randn(3, 2)
    assert torch.equal(port_mesh.globalize(cpu_mesh(2), x), x)
    np.testing.assert_array_equal(port_mesh.host_gather(x), x.numpy())


# -- the fusion trajectory with a mock UNet ------------------------------------------


def port_mock(x, t, ctx, pooled, concept_idx):
    """The JAX package's ``tests/test_fusion_sampler.py::mock_unet`` with the
    context mean taken per row: a mean over the whole batch couples the
    rows, so no row split (the port's, which runs each shard alone) could
    reproduce it, while JAX's sharded call still sees the whole logical
    batch."""
    tag = pooled[:, 0][:, None, None, None]
    idx = concept_idx.float()[:, None, None, None]
    return (torch.tanh(0.3 * x) * (1.0 + 0.03 * tag) + 0.01 * (t / 1000.0) + 0.02 * idx
            + 0.001 * ctx.mean(dim=(1, 2))[:, None, None, None])


def jax_mock(params, x, t, ctx, pooled, concept_idx):
    import jax.numpy as jnp

    tag = pooled[:, 0][:, None, None, None]
    idx = concept_idx.astype(jnp.float32)[:, None, None, None]
    tf = jnp.asarray(t, jnp.float32) / 1000.0
    return (jnp.tanh(0.3 * x) * (1.0 + 0.03 * tag) + 0.01 * tf + 0.02 * idx
            + 0.001 * jnp.mean(ctx, axis=(1, 2))[:, None, None, None])


def _mock_case(num_seeds, n_timesteps, resampling_steps, jumping_steps):
    """Embeddings (rows tagged as in the JAX test), half masks and an
    initial latent, for both packages."""
    rng = np.random.default_rng(num_seeds * 100 + n_timesteps)

    def rows(n, tag0):
        ctx = (0.1 * rng.standard_normal((n, 4, 8))).astype(np.float32)
        pooled = np.zeros((n, 6), np.float32)
        pooled[:, 0] = tag0 + np.arange(n)
        return ctx, pooled

    embeds = [*rows(2, 0.0), *rows(N - 1, 10.0), *rows(N + 1, 20.0)]
    fg = np.zeros((N - 1, H * 8, W * 8), np.float32)
    fg[0, :, : W * 4] = 1.0
    fg[1, :, W * 4:] = 1.0
    x_init = rng.standard_normal((num_seeds, H, W, 4)).astype(np.float32)
    kw = dict(n_timesteps=n_timesteps, num_concepts=N, height=H * 8, width=W * 8,
              resampling_steps=resampling_steps, jumping_steps=jumping_steps)
    return embeds, fg, x_init, kw


@pytest.mark.parametrize("n_dev, num_seeds", [(2, 8), (4, 8), (4, 1)])
def test_seed_sharded_trajectory_matches_unsharded_and_jax(n_dev, num_seeds):
    """8 seeds over a 2- and a 4-way mesh (the serving layout), and one seed
    over 4 (the latency layout: the joint phase's 2 rows and the prologue's
    padded to 4) — the JAX package's ``tests/test_parallel.py`` cases."""
    import jax
    import jax.numpy as jnp

    from tweediemix_tpu.fusion import sampler as jax_sampler
    from tweediemix_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tweediemix_tpu.parallel.mesh import seed_sharded_unet_fn as jax_seed_sharded
    from tweediemix_tpu.schedulers import ddim as jax_ddim

    steps = (10, 2, 0) if num_seeds > 1 else (8, 1, 1)
    embeds, fg, x_init, kw = _mock_case(num_seeds, *steps)
    table = port_ddim.DDIMTable.create(n_steps=kw["n_timesteps"])
    cfg = port_sampler.FusionConfig(**kw)
    pe = port_sampler.TextEmbeds(*(torch.from_numpy(a) for a in embeds))
    args = dict(fg_masks=torch.from_numpy(fg), num_seeds=num_seeds, x_init=torch.from_numpy(x_init))
    want = port_sampler.FusionSampler(table, cfg, port_mock).run(pe, 0, **args)
    mesh = cpu_mesh(n_dev)
    calls = []

    def counted(*a):
        calls.append(a[0].shape[0])
        return port_mock(*a)

    got = port_sampler.FusionSampler(
        table, cfg, port_mesh.seed_sharded_unet_fn(mesh, counted)).run(pe, 0, **args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MOCK_TOL, rtol=MOCK_TOL)
    rows_per_call = {-(-r // n_dev) for r in (2 * num_seeds, (N + 1) * num_seeds)}
    assert set(calls) <= rows_per_call and len(calls) == n_dev * cfg.unet_calls()

    jmesh = jax_make_mesh({"dp": n_dev}, devices=jax.devices()[:n_dev])
    jsampler = jax_sampler.FusionSampler(jax_ddim.DDIMTable.create(n_steps=kw["n_timesteps"]),
                                         jax_sampler.FusionConfig(**kw),
                                         jax_seed_sharded(jmesh, jax_mock))
    with jmesh:
        jgot = jsampler.run(jax_sampler.TextEmbeds(*(jnp.asarray(a) for a in embeds)),
                            jax.random.PRNGKey(0), fg_masks=jnp.asarray(fg),
                            num_seeds=num_seeds, x_init=jnp.asarray(x_init))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_concept_sharded_unet_fn_matches_jax(n_dev):
    import jax
    import jax.numpy as jnp

    from tweediemix_tpu.parallel.mesh import concept_sharded_unet_fn as jax_concept_sharded
    from tweediemix_tpu.parallel.mesh import make_mesh as jax_make_mesh

    embeds, _, x_init, _ = _mock_case(1, 4, 0, 0)
    ctx, pooled = embeds[4], embeds[5]  # uncond + N concept rows
    x = np.repeat(x_init, N + 1, axis=0)
    idx = np.arange(N + 1, dtype=np.int32)
    got = port_mesh.concept_sharded_unet_fn(cpu_mesh(n_dev), port_mock)(
        torch.from_numpy(x), 501, torch.from_numpy(ctx), torch.from_numpy(pooled),
        torch.from_numpy(idx).long())
    want = port_mock(torch.from_numpy(x), 501, torch.from_numpy(ctx), torch.from_numpy(pooled),
                     torch.from_numpy(idx).long())
    assert torch.equal(got, want)
    jmesh = jax_make_mesh({"dp": n_dev}, devices=jax.devices()[:n_dev])
    wrapped = jax_concept_sharded(jmesh, lambda *a: jax_mock(None, *a))
    with jmesh:
        jwant = jax.jit(wrapped)(jnp.asarray(x), 501, jnp.asarray(ctx), jnp.asarray(pooled),
                                 jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=JAX_TOL, rtol=JAX_TOL)
    with pytest.raises(ValueError, match="do not divide"):
        port_mesh.concept_sharded_unet_fn(cpu_mesh(3), port_mock)(
            torch.from_numpy(x), 501, torch.from_numpy(ctx), torch.from_numpy(pooled),
            torch.from_numpy(idx).long())


# -- a W8A8 UNet under a mesh ---------------------------------------------------------


def test_meshed_w8a8_unet_call_equals_jax_meshed_not_the_cached_call(monkeypatch):
    """Under ``quant`` ``precompute_cross_kv`` projects a non-stacked K/V
    (the LoRA mode's) in float while the in-module path quantises it. The
    meshed sampler's replicas project it in their modules (as in the JAX
    package), so a meshed W8A8 call equals the JAX package's meshed call,
    int8 K/V sites included, and not the port's unsharded call, whose runner
    builds the K/V with ``precompute_cross_kv``. The int8
    sites are teacher-forced as in ``test_torch_port_quant.py``: each
    shard's site gets its rows of the JAX site's input (the JAX call runs
    the padded batch at once, the port one shard after another)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_port_quant import MODEL_TOL, _torch, _unet_case, jax_site_inputs
    from tweediemix_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tweediemix_tpu.parallel.mesh import seed_sharded_unet_fn as jax_seed_sharded
    from tweediemix_tpu_torch.models import unet2d as port_unet2d
    from tweediemix_tpu_torch.ops import quant as port_quant

    # LoRA slots: the cross-attention K/V are plain projections (stacked
    # concept K/V are float in both paths)
    model, params, port, inputs = _unet_case("micro", dict(lora_slots=3, lora_rank=2,
                                                           quant="int8"), lora_up=0.05)
    x, ctx, pooled, tids, idx = inputs  # 3 rows: padded to 4 over 2 devices

    def jax_unet(p, x, t, c, pl, i):
        return model.apply({"params": p}, x, t, c, pl, jnp.asarray(tids[:1]).repeat(x.shape[0], 0), i)

    jmesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    with jax_site_inputs(monkeypatch) as recorded, jax.disable_jit(), jmesh:
        want = np.asarray(jax_seed_sharded(jmesh, jax_unet)(params, x, jnp.int32(501), ctx, pooled,
                                                            idx))
    px, pctx, ppooled, ptids, pidx = _torch(inputs)
    calls = []

    def port_unet(x, t, c, pl, i):
        calls.append(x.shape[0])
        return port(x, t, c, pl, ptids[:1].expand(x.shape[0], 6), i)

    queue, worst = [], []

    def force(fn, kind):
        def wrapped(site_x, *args, **kwargs):
            if not queue:  # the next shard replays every site on its rows
                queue.extend(recorded)
            want_kind, full = queue.pop(0)
            assert want_kind == kind
            shard = len(calls) - 1
            per = full.shape[0] // 2
            forced = torch.from_numpy(full[shard * per:(shard + 1) * per].copy())
            assert tuple(forced.shape) == tuple(site_x.shape), (forced.shape, site_x.shape)
            worst.append(float((site_x - forced).abs().max() / (forced.abs().max() + 1e-6)))
            return fn(forced, *args, **kwargs)
        return wrapped

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(port_quant, "w8a8_matmul", force(port_quant.w8a8_matmul, "matmul"))
        got = port_mesh.seed_sharded_unet_fn(cpu_mesh(2), port_unet)(px, 501, pctx, ppooled, pidx)
    assert calls == [2, 2] and not queue and max(worst) <= MODEL_TOL
    assert len(recorded) == len(port_quant.quant_sites(port))  # K/V projections included
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL, rtol=MODEL_TOL)
    with torch.no_grad():
        cached = port(px, 501, pctx, ppooled, ptids, pidx,
                      cross_kv=port_unet2d.precompute_cross_kv(port, pctx, pidx))
    assert np.abs(cached.numpy() - want).max() > 10 * MODEL_TOL * np.abs(want).max()


# -- the video loop ------------------------------------------------------------------


def test_video_clips_sharded_match_single_device_and_jax(monkeypatch):
    """Two tiny UNet3D clips over a 2-way mesh (each shard runs the whole
    loop for its clip's interleaved CFG pair) against the unsharded port
    and the JAX package's ``_sharded_loop`` (``generate(mesh_devices=2)``),
    the JAX run's noise fed to the port; and a clip count that does not
    divide the mesh raises the JAX package's message."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_port_video import F, HW, MODEL_TOL, _t, numpy_params
    from tweediemix_tpu.models import unet3d as jax_unet3d
    from tweediemix_tpu.models import vae as jax_vae
    from tweediemix_tpu.video import pipeline as jax_video
    from tweediemix_tpu_torch.models import unet3d as port_unet3d
    from tweediemix_tpu_torch.models import vae as port_vae
    from tweediemix_tpu_torch.models.convert import load_params
    from tweediemix_tpu_torch.video import pipeline as port_video

    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    cfg = jax_unet3d.UNet3DConfig.tiny(attention_head_dim=32)
    model = jax_unet3d.UNet3DConditionModel(cfg)
    b, rng = 2, np.random.default_rng(17)
    ctx = (0.3 * rng.standard_normal((b, 6, 32))).astype(np.float32)
    uctx = np.zeros((1, 6, 32), np.float32)
    img = (rng.uniform(size=(b, 16, 16, 3)) * 2 - 1).astype(np.float32)
    emb = (0.3 * rng.standard_normal((b, 1, 32))).astype(np.float32)
    lat = np.zeros((b, F, HW, HW, 4), np.float32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), lat, jnp.int32(1), ctx, lat, emb,
                              jnp.float32(8.0))["params"]
    params = numpy_params(abstract, 11)
    jvae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny(scaling_factor=0.18215))
    vparams = numpy_params(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1))["params"], 12)
    vkw = dict(num_frames=F, height=16, width=16, latent_factor=2, n_timesteps=3,
               injection_timestep=0.34)
    jpipe = jax_video.I2VPipeline(jax_video.VideoConfig(**vkw), model, params, jvae, vparams)
    unet = port_unet3d.UNet3DConditionModel(port_unet3d.UNet3DConfig.tiny(attention_head_dim=32),
                                            device="cpu")
    load_params(unet, params)
    vae = port_vae.AutoencoderKL(port_vae.VAEConfig.tiny(scaling_factor=0.18215), device="cpu")
    load_params(vae, vparams)
    ppipe = port_video.I2VPipeline(port_video.VideoConfig(**vkw), unet, vae, device="cpu")

    seed = 5
    want = np.asarray(jpipe.generate(ctx, uctx, img, emb, seed=seed, mesh_devices=2))
    key = jax.random.PRNGKey(seed)
    x = np.stack([np.asarray(jax.random.normal(k, (F, HW, HW, 4), jnp.float32))
                  for k in (key, jax.random.fold_in(key, 1001))])
    k1 = jax.random.fold_in(key, 1)
    noise = np.stack([np.asarray(jax.random.normal(k, (HW, HW, 4), jnp.float32))
                      for k in (k1, jax.random.fold_in(k1, 1001))])
    args = (_t(ctx), _t(uctx), _t(img), _t(emb))
    kw = dict(x_init=_t(x), posterior_noise=_t(noise))
    one = ppipe.generate(*args, **kw)
    loop_calls = []
    monkeypatch.setattr(ppipe, "_loop_shards",
                        lambda shards, f=ppipe._loop_shards: loop_calls.append(len(shards)) or f(shards))
    got = ppipe.generate(*args, mesh_devices=2, **kw)
    assert loop_calls == [2] and got.shape == want.shape == (b, F, 16, 16, 3)
    assert np.abs(got.numpy() - one.numpy()).max() <= MODEL_TOL * np.abs(one.numpy()).max()
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL, rtol=MODEL_TOL)
    with pytest.raises(AssertionError, match="clip batch 2 must divide over 4 devices"):
        ppipe.generate(*args, mesh_devices=4, **kw)


# -- the CLIs -------------------------------------------------------------------------


FUSION_FLAGS = ["--model_preset", "tiny", "--prompt", "a cat+a dog+bg",
                "--prompt_orig", "a cat and a dog", "--concepts", "cat+dog+bg",
                "--modifier_token", "<a>+<b>+<c>", "--seg_concepts", "a cat+a dog",
                "--seg_preset", "heuristic", "--n_timesteps", "4", "--t_cond", "0.5",
                "--resampling_steps", "1", "--jumping_steps", "1",
                "--resolution_h", "128", "--resolution_w", "128", "--seed", "11"]


def _pngs(out):
    from tweediemix_tpu_torch.utils.image import read_png

    return {f: read_png(os.path.join(out, f))[1].astype(int) for f in sorted(os.listdir(out))}


def test_fusion_cli_and_server_mesh_devices_2(tmp_path):
    """The fusion CLI with ``--mesh_devices 2 --num_seeds 2`` writes the two
    PNGs of the unsharded run (within one level); the server, given the same
    request as one JSONL line, returns the meshed CLI's PNGs exactly."""
    from tweediemix_tpu_torch.cli import fusion_sampling, serve

    runs = {}
    for m in ("1", "2"):
        out = str(tmp_path / f"mesh{m}")
        assert fusion_sampling.main(FUSION_FLAGS + ["--num_seeds", "2", "--mesh_devices", m,
                                                    "--output_path", out], device="cpu") == 0
        runs[m] = _pngs(out)
    assert sorted(runs["2"]) == ["a cat and a dog_11.png", "a cat and a dog_12.png"]
    assert sorted(runs["1"]) == sorted(runs["2"])
    for name in runs["1"]:
        assert np.abs(runs["1"][name] - runs["2"][name]).max() <= 1
    stdout = io.StringIO()
    req = {"id": "m", "seed": 11, "num_seeds": 2, "output_path": str(tmp_path / "served")}
    assert serve.main(FUSION_FLAGS + ["--mesh_devices", "2"],
                      stdin=io.StringIO(json.dumps(req) + "\n"), stdout=stdout, device="cpu") == 0
    resp = json.loads(stdout.getvalue())
    assert resp["status"] == "ok" and len(resp["files"]) == 2
    served = _pngs(str(tmp_path / "served"))
    assert all(np.array_equal(served[name], runs["2"][name]) for name in served)


def test_pipeline_mesh_sampler_is_kept_per_mesh_and_rejects_zero():
    from tweediemix_tpu_torch.cli import fusion_sampling

    opt = fusion_sampling.build_parser().parse_args(FUSION_FLAGS)
    pipe = fusion_sampling.build_pipeline(opt, "cpu")
    one = pipe.sampler_for(1)
    two = pipe.sampler_for(2)
    assert one is pipe.sampler and two is pipe.sampler_for(2) and two is not one
    # the unsharded sampler calls the pipeline's runner; the meshed one each
    # replica's forward, the K/V projected in its modules
    assert one.unet_fn == pipe._unet_fn
    fns = inspect.getclosurevars(two.unet_fn).nonlocals["fns"]
    assert [(f.func, f.keywords) for f in fns] == [(pipe._unet_fn, {"unet": pipe.unet})] * 2
    assert two.segment_fn is one.segment_fn
    with pytest.raises(ValueError, match="at least 1"):
        pipe.sampler_for(0)


def test_video_cli_mesh_devices_2(tmp_path):
    """``--num_seeds 2 --mesh_devices 2`` writes a GIF per clip, each clip's
    frames equal to the unsharded run's within one level."""
    from tweediemix_tpu_torch.cli import run_video
    from tweediemix_tpu_torch.utils.image import read_gif, write_png

    png = str(tmp_path / "in.png")
    write_png(png, np.random.default_rng(0).integers(0, 256, (24, 20, 3), dtype=np.uint8))
    frames = {}
    for m in ("1", "2"):
        out = str(tmp_path / f"mesh{m}" / "clip.gif")
        assert run_video.main(["--model_preset", "tiny", "--image", png, "--prompt", "a cat",
                               "--output", out, "--num_frames", "2", "--height", "32",
                               "--width", "32", "--n_timesteps", "2", "--num_seeds", "2",
                               "--mesh_devices", m], device="cpu") == 0
        frames[m] = [read_gif(os.path.join(os.path.dirname(out), f))[1].astype(int)
                     for f in ("clip.gif", "clip_1.gif")]
    for a, b in zip(frames["1"], frames["2"]):
        assert a.shape == (2, 32, 32, 3) and np.abs(a - b).max() <= 1


# -- the compile cache ----------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "1", "on", "0", "off", "", "DIR"])
def test_compile_cache_directory_follows_the_variable(tmp_path, monkeypatch, value):
    """``enable_compile_cache`` points the kernels' builds at the default
    directory (unset, ``1``, ``on``), at a temporary directory of this
    process (``0``, ``off``, empty: it returns None) or at the given path;
    ``library_path`` and the augment library land there. Nothing is built."""
    from tweediemix_tpu_torch.ops import cuda_build
    from tweediemix_tpu_torch.training import augment
    from tweediemix_tpu_torch.utils.compile_cache import default_cache_dir, enable_compile_cache

    monkeypatch.setattr(cuda_build, "_build_dir_override", None)
    given = str(tmp_path / "cache")
    if value is None:
        monkeypatch.delenv("TWEEDIEMIX_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("TWEEDIEMIX_COMPILE_CACHE", given if value == "DIR" else value)
    got = enable_compile_cache()
    where = cuda_build.library_path("flash_attention").parent
    assert augment.library_path().parent == where
    if value in (None, "1", "on"):
        assert got == default_cache_dir() == str(cuda_build.BUILD_DIR) and where == cuda_build.BUILD_DIR
    elif value == "DIR":
        assert got == given and str(where) == given and os.path.isdir(given)
    else:
        assert got is None and where != cuda_build.BUILD_DIR and where.is_dir()
        assert enable_compile_cache() is None and cuda_build.build_dir() == where  # one per process
    assert enable_compile_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert cuda_build.build_dir() == tmp_path / "arg" and not list((tmp_path / "arg").iterdir())
