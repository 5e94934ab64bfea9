"""The port's warm fusion server (``cli/serve.py``) on the CPU: the JSONL
contract of the JAX package's ``tests/test_serve.py``, and the served PNG
bit for bit against the port's one-shot CLI's (one build_pipeline, one seed)."""

import argparse
import io
import json
import os

import numpy as np
import pytest
import torch

from tweediemix_tpu_torch.cli import fusion_sampling, serve
from tweediemix_tpu_torch.utils.image import read_png

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PROMPT = "photo of a cat running+photo of a dog running+mountain background"
PROMPT_ORIG = "photo of a cat and a dog running"


def startup_flags(default_out):
    return ["--model_preset", "tiny", "--prompt", PROMPT, "--prompt_orig", PROMPT_ORIG,
            "--concepts", "cat+dog+mountain", "--modifier_token", "<cat1>+<dog1>+<mountain1>",
            "--seg_concepts", "a cat+a dog", "--seg_preset", "heuristic",
            "--output_path", str(default_out), "--n_timesteps", "4", "--t_cond", "0.5",
            "--resampling_steps", "0", "--jumping_steps", "1",
            "--resolution_h", "128", "--resolution_w", "128"]


def test_serve_jsonl_roundtrip(tmp_path):
    out1, out2, out3 = tmp_path / "o1", tmp_path / "o2", tmp_path / "o3"
    reqs = [
        {"id": "a", "seed": 3, "output_path": str(out1)},
        {"id": "bad", "prompt": "only one concept", "output_path": str(out1)},
        {"id": "b", "seed": 4, "output_path": str(out2), "prompt_orig": "a cat and a dog sitting"},
        {"id": "c", "seed": 5, "num_seeds": 2, "output_path": str(out3),
         "prompt": PROMPT + "||" + PROMPT.replace("running", "sitting"),
         "prompt_orig": PROMPT_ORIG + "||two pets"},
    ]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n\n"
                        + json.dumps({"id": "after the empty line"}) + "\n")
    stdout = io.StringIO()
    assert serve.main(startup_flags(tmp_path / "default"), stdin=stdin, stdout=stdout,
                      device="cpu") == 0
    lines = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert [line["id"] for line in lines] == ["a", "bad", "b", "c"]
    assert lines[0]["status"] == "ok" and lines[0]["warm"] is False
    assert lines[0]["files"] and all(f.endswith(".png") for f in lines[0]["files"])
    # a malformed prompt (wrong '+' count) errors without stopping the server
    assert lines[1]["status"] == "error" and "3" in lines[1]["error"]
    # the same geometry again is warm; the files take the request's orig stem
    assert lines[2]["status"] == "ok" and lines[2]["warm"] is True and lines[2]["latency_s"] > 0
    assert os.path.basename(lines[2]["files"][0]) == "a cat and a dog sitting_4.png"
    # a '||' pair at num_seeds 2 is a new geometry: not warm, one PNG per set
    assert lines[3]["status"] == "ok" and lines[3]["warm"] is False
    assert [os.path.basename(f) for f in lines[3]["files"]] == [f"{PROMPT_ORIG}_5.png",
                                                                "two pets_6.png"]


def test_warm_flag_is_per_trace_geometry(tmp_path):
    """A request with a new num_seeds is a new geometry and reports
    warm=False even after earlier successful requests; repeating it is then
    warm (a stub pipeline, so only the keying is tested)."""

    class StubPipe:
        def prepare_text_embeds(self, *a, **k):
            return None

        def sample(self, embeds, seed, fg_masks, num_seeds, mesh_devices):
            return torch.zeros((num_seeds, 8, 8, 3))

    opt = argparse.Namespace(
        prompt="p", prompt_orig="orig", negative_prompt="", seed=1, num_seeds=1,
        output_path=str(tmp_path), mask_dir=None, concepts="c", modifier_token="<c1>",
        seg_concepts="a c", resolution_h=8, resolution_w=8, mesh_devices=1,
    )
    served = set()
    r1 = serve.handle_request(StubPipe(), opt, {"num_seeds": 1}, served)
    r2 = serve.handle_request(StubPipe(), opt, {"num_seeds": 1}, served)
    r3 = serve.handle_request(StubPipe(), opt, {"num_seeds": 2}, served)
    r4 = serve.handle_request(StubPipe(), opt, {"num_seeds": 2}, served)
    assert [r["warm"] for r in (r1, r2, r3, r4)] == [False, True, False, True]
    assert served == {(1, True), (2, True)}


def test_served_png_equals_the_one_shot_cli_png(tmp_path, capsys):
    """One build_pipeline, one seed: the server's first request writes the PNG the
    one-shot fusion CLI writes, bit for bit."""
    flags = startup_flags(tmp_path / "default")
    assert fusion_sampling.main(flags + ["--seed", "7", "--output_path", str(tmp_path / "cli")],
                                device="cpu") == 0
    stdout = io.StringIO()
    req = {"id": "a", "seed": 7, "output_path": str(tmp_path / "served")}
    assert serve.main(flags, stdin=io.StringIO(json.dumps(req) + "\n"), stdout=stdout,
                      device="cpu") == 0
    resp = json.loads(stdout.getvalue())
    assert resp["status"] == "ok"
    header, served = read_png(resp["files"][0])
    _, one_shot = read_png(str(tmp_path / "cli" / f"{PROMPT_ORIG}_7.png"))
    assert header["width"] == 32 and np.array_equal(served, one_shot)
    timings = json.loads(capsys.readouterr().err.split("timings: ", 1)[1].splitlines()[0])
    assert set(timings) == {"load_s", "seg_load_s", "build_s"}


def test_serve_mesh_devices_raises_naming_the_roadmap_item(tmp_path):
    """``--mesh_devices`` > 1 is ported (``tests/test_torch_port_parallel.py``
    serves a request over a 2-way mesh); a mesh of no device raises before
    the pipeline is built. The name is kept from when every mesh raised."""
    with pytest.raises(ValueError, match="--mesh_devices must be at least 1"):
        serve.main(startup_flags(tmp_path) + ["--mesh_devices", "0"], stdin=io.StringIO(""),
                   stdout=io.StringIO(), device="cpu")
    assert not list(tmp_path.glob("**/*.png"))
