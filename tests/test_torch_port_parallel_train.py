"""Data-parallel training (``cli/train.py --dp_devices``/``--multihost``) and
a two-process serving trajectory, in real gloo processes on the CPU.

* ``--dp_devices 2 --train_batch_size 1`` (two ranks spawned by the CLI)
  against one process at ``--train_batch_size 2``, with prior preservation
  and a modifier token: the global batch [2 instance rows; 2 prior rows]
  splits so that rank 0 holds only instance rows and rank 1 only prior
  rows, so the losses and deltas agree only if the loss divides by the
  global batch's counts. ``--adam_epsilon 1`` with a large learning rate
  makes the update proportional to the gradient, so a gradient off by a
  constant factor (per-rank means averaged) shows in the delta too.
* two ``--multihost`` processes launched here, as the JAX package's pair
  (``tests/test_parallel.py``); a single-process ``--multihost`` run.
* the micro fusion trajectory, 4 seeds over 2 ranks (``make_mesh()`` over
  the process group, ``seed_sharded_unet_fn`` all-gathering each call's
  eps), against one process.

Tolerances: 1e-5 between a data-parallel run and one process (fp32 sums
in another order); the ranks of one job bit for bit. Workers run this file
as a script (``python tests/test_torch_port_parallel_train.py worker ...``)
with ``OMP_NUM_THREADS=1`` under a hard timeout; they import no JAX.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a worker script
    sys.path.insert(0, REPO)

from tweediemix_tpu_torch.cli import train as port_train  # noqa: E402
from tweediemix_tpu_torch.concepts.delta import load_reference_delta  # noqa: E402
from tweediemix_tpu_torch.utils.image import write_png  # noqa: E402

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

DP_TOL = 1e-5
WORKER_TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _images(root):
    inst, cls = os.path.join(root, "inst"), os.path.join(root, "cls")
    os.makedirs(inst)
    os.makedirs(cls)
    rng = np.random.default_rng(0)
    for i in range(3):
        write_png(os.path.join(inst, f"{i}.png"), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    for i in range(2):
        write_png(os.path.join(cls, f"{i:05d}.png"), rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
    return inst, cls


def train_args(root, out, *extra):
    inst, cls = os.path.join(root, "inst"), os.path.join(root, "cls")
    return ["--model_preset", "tiny", "--instance_data_dir", inst,
            "--instance_prompt", "a <new1> cat", "--class_data_dir", cls,
            "--class_prompt", "a cat", "--with_prior_preservation", "--num_class_images", "2",
            "--modifier_token", "<new1>", "--resolution", "32", "--max_train_steps", "2",
            "--learning_rate", "0.1", "--adam_epsilon", "1.0", "--dataloader_num_workers", "0",
            "--output_dir", out, "--report_to", os.path.join(out, "log"), *extra]


def _deltas_close(a, b, tol):
    for coll in ("unet", "modifier_token", "modifier_token_2"):
        assert set(a[coll]) == set(b[coll]) and a[coll], coll
        for k in a[coll]:
            torch.testing.assert_close(a[coll][k], b[coll][k], rtol=0, atol=tol)


def _log(out):
    with open(os.path.join(out, "log", "train.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_dp_devices_2_at_batch_1_equals_one_process_at_batch_2(tmp_path):
    root = str(tmp_path)
    _images(root)
    one, dp = str(tmp_path / "one"), str(tmp_path / "dp")
    assert port_train.main(train_args(root, one, "--train_batch_size", "2"), device="cpu") == 0
    assert port_train.main(train_args(root, dp, "--train_batch_size", "1", "--dp_devices", "2"),
                           device="cpu") == 0
    want, got = load_reference_delta(os.path.join(one, "delta-2.bin")), \
        load_reference_delta(os.path.join(dp, "delta-2.bin"))
    _deltas_close(got, want, DP_TOL)
    moved = max(float(v.abs().max()) for v in want["modifier_token"].values())
    assert moved > 0
    for a, b in zip(_log(dp), _log(one), strict=True):
        for k in ("loss", "instance_loss", "prior_loss"):
            assert abs(a[k] - b[k]) <= DP_TOL * max(1.0, abs(b[k])), (k, a, b)
    assert not torch.distributed.is_initialized()


def test_multihost_single_process_equals_the_plain_run(tmp_path):
    """One ``--multihost`` rank (gloo, world size 1): the gradient sum over
    one rank, the global counts and draws are the plain run's, bit for bit;
    the process group is gone when ``main`` returns."""
    root = str(tmp_path)
    _images(root)
    plain, mh = str(tmp_path / "plain"), str(tmp_path / "mh")
    assert port_train.main(train_args(root, plain, "--save_steps", "1"), device="cpu") == 0
    assert port_train.main(train_args(root, mh, "--save_steps", "1", "--multihost",
                                      "--coordinator_address", f"127.0.0.1:{_free_port()}",
                                      "--num_processes", "1", "--process_id", "0"),
                           device="cpu") == 0
    assert not torch.distributed.is_initialized()
    _deltas_close(load_reference_delta(os.path.join(mh, "delta-2.bin")),
                  load_reference_delta(os.path.join(plain, "delta-2.bin")), 0.0)
    assert sorted(os.listdir(os.path.join(mh, "resume"))) == ["state_1.pt", "state_2.pt"]


def _launch(tmp_path, role, n, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), role, coord, str(n),
                               str(rank), *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_multihost_two_processes(tmp_path):
    """Two ``--multihost`` ranks (data seeds 7 and 8, each loading its own
    rows), saving at every step: both end with equal parameters, rank 0
    alone writes the deltas, the log and the lines; both wait for the
    resume checkpoint."""
    root = str(tmp_path)
    _images(root)
    out = str(tmp_path / "out")
    outs = _launch(tmp_path, "train", 2, root, out)
    p0, p1 = (np.load(os.path.join(out, f"params_{r}.npz")) for r in (0, 1))
    assert sorted(p0.files) == sorted(p1.files) and p0.files
    for k in p0.files:
        np.testing.assert_array_equal(p0[k], p1[k])
    assert "saved" in outs[0] and "data parallelism over 2 devices in 2 processes" in outs[0]
    assert "saved" not in outs[1] and "step 1:" not in outs[1] and "timings" not in outs[1]
    assert sorted(f for f in os.listdir(out) if f.startswith("delta")) == ["delta-1.bin",
                                                                         "delta-2.bin"]
    assert [r["step"] for r in _log(out)] == [1, 2]
    assert sorted(os.listdir(os.path.join(out, "resume"))) == ["state_1.pt", "state_2.pt"]


def test_two_process_serving_trajectory_equals_one_process(tmp_path):
    """The micro fusion trajectory at 4 seeds over 2 gloo ranks: each rank
    runs its 2 seed rows of every UNet call and all-gathers the eps; both
    ranks gather the same result bit for bit, equal to one process."""
    outs = _launch(tmp_path, "serve", 2, str(tmp_path))
    got = [np.load(str(tmp_path / f"serve_{r}.npy")) for r in (0, 1)]
    np.testing.assert_array_equal(got[0], got[1])
    assert "primary=True" in outs[0] and "primary=False" in outs[1]
    want = serve_trajectory(None)
    assert got[0].shape == want.shape == (4, 8, 8, 4)
    np.testing.assert_allclose(got[0], want, atol=DP_TOL, rtol=DP_TOL)


# -- the workers ----------------------------------------------------------------------


def serve_trajectory(mesh):
    """The micro fusion trajectory (seeded UNet, embeddings, masks), 4
    seeds, over ``mesh`` or unsharded; returns the final latents."""
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig, FusionSampler, TextEmbeds
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.parallel.mesh import globalize, seed_sharded_unet_fn
    from tweediemix_tpu_torch.schedulers.ddim import DDIMTable

    torch.manual_seed(0)
    cfg = UNetConfig.micro(concept_slots=4)
    unet = UNet2DConditionModel(cfg, device="cpu").eval()
    fus = FusionConfig(n_timesteps=4, guidance_scale=0.8, t_cond=0.3, resampling_steps=1,
                       jumping_steps=1, height=64, width=64, num_concepts=3)
    gen = torch.Generator().manual_seed(3)

    def rows(n):
        return (0.1 * torch.randn((n, 16, cfg.cross_attention_dim), generator=gen),
                0.1 * torch.randn((n, cfg.pooled_projection_dim), generator=gen))

    embeds = TextEmbeds(*rows(2), *rows(2), *rows(4))
    fg = torch.zeros((2, 64, 64))
    fg[0, :, :32] = 1.0
    fg[1, :, 32:] = 1.0
    tids = torch.tensor([[64.0, 64, 0, 0, 64, 64]])

    def unet_fn(x, t, ctx, pooled, idx, cross_kv=None):
        return unet(x, t, ctx, pooled, tids.expand(x.shape[0], 6), idx, cross_kv=cross_kv)

    if mesh is not None:  # every rank computed the same inputs: they stay where they are
        embeds, fg = globalize(mesh, (embeds, fg))
    sampler = FusionSampler(DDIMTable.create(n_steps=4), fus,
                            unet_fn if mesh is None else seed_sharded_unet_fn(mesh, unet_fn))
    with torch.no_grad():
        return sampler.run(embeds, 3, fg_masks=fg, num_seeds=4).numpy()


def _serve_worker(coord, n, rank, out_dir):
    from tweediemix_tpu_torch.parallel import mesh as pm

    pm.init_distributed(coord, n, rank, device="cpu")
    mesh = pm.make_mesh()
    assert mesh.size == n and list(mesh.local_shards()) == [rank]
    x = torch.from_numpy(serve_trajectory(mesh))
    # the output path: each rank hands back its own seeds, gathered on every rank
    per = x.shape[0] // n
    out = pm.host_gather(x[rank * per:(rank + 1) * per], mesh)
    np.save(os.path.join(out_dir, f"serve_{rank}.npy"), out)
    print(f"WORKER_OK primary={pm.is_primary_process()}")
    pm.destroy_distributed()


def _train_worker(coord, n, rank, root, out):
    from tweediemix_tpu_torch.training import trainer

    make_step = trainer.make_full_train_step
    kept = {}

    def keep(*args, **kw):
        step = make_step(*args, **kw)

        def recorded(state, *a, **k):
            kept["params"] = state.params
            return step(state, *a, **k)

        return recorded

    trainer.make_full_train_step = keep
    rc = port_train.main(train_args(root, out, "--save_steps", "1", "--seed", "7", "--multihost",
                                    "--coordinator_address", coord, "--num_processes", str(n),
                                    "--process_id", str(rank)), device="cpu")
    assert rc == 0 and not torch.distributed.is_initialized()
    np.savez(os.path.join(out, f"params_{rank}.npz"),
             **{k: p.detach().numpy() for k, p in kept["params"].items()})


if __name__ == "__main__":
    role, coord, n, rank, *rest = sys.argv[1:]
    {"serve": _serve_worker, "train": _train_worker}[role](coord, int(n), int(rank), *rest)
