"""The check that decides ``correct``, driven through a whole run of each
cell at a tiny size on the CPU (the harness's look for a card skipped, the
launch counters read as the cell expects, since the CPU runs the kernels'
plain versions): a sound run comes out correct, and each fault the cell can
have, planted in the program underneath, comes out not correct. The cells
run on one device, so a missing exchange between devices is no fault they
can have."""

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import FUSION, W8A8, tiny_fusion, tiny_video

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
SEED = 3 * 2**31 + 11


def run_cell(cell_data, capsys, monkeypatch, miss_kernel=False):
    cell, wl, cfg = cell_data
    for key in wl["env"]:
        monkeypatch.setenv(key, wl["env"][key])
    driver = __import__(f"benchmark.systems.{cfg['system']}", fromlist=["System"])
    calls = {"n": 0}

    def counts(self):
        calls["n"] += 1
        want = self.expected_launches()
        if miss_kernel and calls["n"] == 2:  # the first request's end reads one launch short
            return {k: v - 1 for k, v in want.items()}
        return want if calls["n"] % 2 == 0 else {k: 0 for k in want}

    monkeypatch.setattr(driver.System, "launch_counts", counts)
    rc = harness.run(cell, SEED, 0.2, False, 0.0, device="cpu", chips_check=False,
                     cell_data=(wl, cfg))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the check compares exactly what its system declares, sound or not
    assert set(line["compared"]) == set(driver.System.compares(wl)) | {"missed_kernel_path"}
    return line


def half_batch(forward):
    """The first half of the rows computed, the rest given their mean."""
    def fwd(self, x, *args, **kw):
        out = forward(self, x, *args, **kw)
        h = max(1, out.shape[0] // 2)
        return torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand_as(out[h:])])
    return fwd


@pytest.mark.parametrize("cell", [FUSION, W8A8])
def test_fusion_faults_come_out_not_correct(cell, capsys, monkeypatch):
    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionSampler
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel

    data = tiny_fusion(cell)
    sound = run_cell(data, capsys, monkeypatch)
    assert sound["correct"], sound["compared"]

    def fault(name, target, attr, value):
        with monkeypatch.context() as m:
            m.setattr(target, attr, value)
            line = run_cell(data, capsys, m)
        assert not line["correct"], (name, line["compared"])
        return line["compared"]

    fused = FusionSampler.fused_scan

    def stuck(self, embeds, x, masks, start, stop):
        fused(self, embeds, x, masks, start, stop)  # its UNet calls, but the state stays
        return x

    assert fault("state unchanged", FusionSampler, "fused_scan", stuck)["update_rel"]["value"] > 1e-3
    got = fault("half the batch", UNet2DConditionModel, "forward",
                half_batch(UNet2DConditionModel.forward))
    assert got["unet_rel"]["value"] > 1e-2
    decode = TweedieMixPipeline.decode_final
    got = fault("answer altered", TweedieMixPipeline, "decode_final",
                lambda self, x: decode(self, x) * 0.98)
    assert got["decode_abs"]["value"] > 1e-3
    line = run_cell(data, capsys, monkeypatch, miss_kernel=True)
    assert not line["correct"] and line["failed"] == 1


def test_video_faults_come_out_not_correct(capsys, monkeypatch):
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel
    from tweediemix_tpu_torch.video import pipeline

    data = tiny_video()
    sound = run_cell(data, capsys, monkeypatch)
    assert sound["correct"], sound["compared"]

    def fault(name, target, attr, value):
        with monkeypatch.context() as m:
            m.setattr(target, attr, value)
            line = run_cell(data, capsys, m)
        assert not line["correct"], (name, line["compared"])
        return line["compared"]

    got = fault("state unchanged", pipeline, "video_rotation_step", lambda x, e, a, b: x)
    assert got["update_rel"]["value"] > 1e-3
    forward = UNet3DConditionModel.forward

    def half(self, sample, *args, **kw):
        if kw.get("return_cache"):
            return forward(self, sample, *args, **kw)
        return half_batch(forward)(self, sample, *args, **kw)

    assert fault("half the batch", UNet3DConditionModel, "forward", half)["unet_rel"]["value"] > 1e-2
    decode = pipeline.I2VPipeline.decode_video
    got = fault("answer altered", pipeline.I2VPipeline, "decode_video",
                lambda self, lat: decode(self, lat) * 0.98)
    assert got["decode_abs"]["value"] > 1e-3
