"""Each cell's control, at a tiny size on the CPU: the control one precision
below the configuration's in the program's place comes out not correct by
the cell's own limits, judged as a run judges (``controls.py`` reads it at
full size on the card)."""

import os

import pytest
import torch

from benchmark.controls import judged
from benchmark.tests.tiny import FUSION, VIDEO, W8A8, tiny_fusion, tiny_video

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.mark.parametrize("cell", [FUSION, W8A8, VIDEO])
def test_control_is_not_correct(cell, monkeypatch):
    _, wl, cfg = tiny_video(cell, "bfloat16") if cell == VIDEO else tiny_fusion(cell, "bfloat16")
    for key in set(wl["env"]) | set(wl["control"].get("program", {}).get("env", {})):
        monkeypatch.setenv(key, os.environ.get(key, "0"))
    out = judged(cell, 5 * 2**32 + 3, 2, device="cpu", cell_data=(wl, cfg))
    assert not out["correct"] and out["fails"], out
    # the bfloat16 update fails by itself (TF32 decodes as fp32 on the CPU)
    assert "update_rel" in out["fails"], out
    if cell == VIDEO:  # the program's int8 build, at its watched layer
        assert "site_rel" in out["fails"], out
