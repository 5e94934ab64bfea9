"""GroundingDINO through the port's entry points on the CPU:
``LangSAM.from_pretrained`` with ``detector="dino"`` and ``"auto"``, the
fusion CLI with ``--detector dino``/``auto`` (SAM and DINO at the boundary
step, to one PNG) and the segment CLI with ``--detector dino`` (a mask PNG
per concept), from a tiny original-layout ``.pth`` with ``vocab.txt``
beside it and a tiny segment-anything ``.pth``. Both packages'
``from_pretrained`` build Swin-B and ViT-H, so these tests patch the port's
``DinoConfig.swin_b`` and ``SAMConfig.vit_h`` to the tiny configs; the
written checkpoints are what ``chip_smoke.py`` writes at full width.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_segment_cli import PROMPT_ORIG, fusion_args
from tweediemix_tpu_torch.cli import fusion_sampling as cli
from tweediemix_tpu_torch.cli import segment as segment_cli
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.models import dino as port_dino
from tweediemix_tpu_torch.segmentation import lang_sam as port_lang_sam
from tweediemix_tpu_torch.segmentation import sam as port_sam
from tweediemix_tpu_torch.utils import image as port_image
from tweediemix_tpu_torch.utils.tokenizer import BertWordPieceTokenizer

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the card phase's checkpoint writer)

SEG_CONCEPTS = "a cat+a dog"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny SAM ``.pth`` (segment-anything names, seeded) and a tiny
    GroundingDINO ``.pth`` in the original layout with ``vocab.txt``
    beside it, in one directory."""
    root = tmp_path_factory.mktemp("weights")
    sam = port_lang_sam.seeded_init_(port_sam.SAM(port_sam.SAMConfig.tiny(), device="cpu"),
                                     torch.Generator().manual_seed(1))
    torch.save(sam.state_dict(), str(root / "sam_tiny.pth"))
    info = chip_smoke.write_dino_checkpoint(str(root / "groundingdino_tiny.pth"),
                                            port_dino.DinoConfig.tiny(), seed=2, device="cpu")
    return root, info


@pytest.fixture
def tiny_presets(monkeypatch):
    monkeypatch.setattr(port_dino.DinoConfig, "swin_b", staticmethod(port_dino.DinoConfig.tiny))
    monkeypatch.setattr(port_sam.SAMConfig, "vit_h", staticmethod(port_sam.SAMConfig.tiny))


def _no_owlvit(*args, **kwargs):
    raise AssertionError("the OWL-ViT loader ran")


@pytest.mark.parametrize("detector", ["dino", "auto"])
def test_from_pretrained_dino_predicts_as_the_checkpoint_model(checkpoints, tiny_presets, monkeypatch,
                                                               detector):
    """From the files, LangSAM predicts exactly what the modules they were
    written from predict; the OWL-ViT loader never runs."""
    root, info = checkpoints
    monkeypatch.setattr(port_convert, "load_detector", _no_owlvit)
    sam_path, dino_path = str(root / "sam_tiny.pth"), str(root / "groundingdino_tiny.pth")
    ls = port_lang_sam.LangSAM.from_pretrained(sam_path, dino_path, detector=detector, device="cpu")
    assert ls.detector is None and isinstance(ls.dino, port_dino.DinoDetector)
    assert sum(t.numel() for t in ls.dino.model.parameters()) == info["params"]
    sam = port_convert.load_sam(sam_path, port_sam.SAMConfig.tiny(), device="cpu")
    model = port_convert.load_dino(dino_path, port_dino.DinoConfig.tiny(), device="cpu")
    direct = port_lang_sam.LangSAM(sam, dino=port_dino.DinoDetector(
        port_dino.DinoConfig.tiny(), model, BertWordPieceTokenizer.from_dir(str(root))))
    image = torch.rand((40, 52, 3), generator=torch.Generator().manual_seed(3))
    got, want = ls.predict_logits(image, "a cat"), direct.predict_logits(image, "a cat")
    assert got[0].shape == (4, 40, 52)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    boxes = got[1]
    assert bool(((boxes >= 0) & (boxes <= 1)).all()) and bool((got[2][:-1] >= got[2][1:]).all())


@pytest.mark.parametrize("detector", ["dino", "auto"])
def test_fusion_cli_segments_with_dino(tmp_path, checkpoints, tiny_presets, monkeypatch, capsys, detector):
    root, _ = checkpoints
    monkeypatch.setattr(port_convert, "load_detector", _no_owlvit)
    out = tmp_path / "out"
    argv = fusion_args(out, "--sam_checkpoint", str(root / "sam_tiny.pth"),
                       "--detector_dir", str(root / "groundingdino_tiny.pth"), "--detector", detector)
    assert cli.main(argv, device="cpu") == 0
    assert [f.name for f in out.glob("*.png")] == [f"{PROMPT_ORIG}_5.png"]
    header, _ = port_image.read_png(str(out / f"{PROMPT_ORIG}_5.png"))
    assert (header["width"], header["height"]) == (32, 32)
    text = capsys.readouterr().out
    seg = json.loads(text.split("segmentation: ", 1)[1].splitlines()[0])
    assert [c for c, _ in seg["top_scores"]] == SEG_CONCEPTS.split("+")
    assert all(0.0 <= s <= 1.0 for _, s in seg["top_scores"])
    assert len(seg["mask_areas"]) == 2 and all(0.0 <= a <= 1.0 for a in seg["mask_areas"])
    timings = json.loads(text.split("timings: ", 1)[1].splitlines()[0])
    assert timings["segment_s"] > 0 and 0 < timings["seg_load_s"] <= timings["load_s"]


def test_segment_cli_writes_a_mask_per_concept_with_dino(tmp_path, checkpoints, tiny_presets, capsys):
    root, _ = checkpoints
    image = (np.random.default_rng(4).random((36, 44, 3)) * 255).astype(np.uint8)
    port_image.write_png(str(tmp_path / "in.png"), image)
    masks = tmp_path / "masks"
    rc = segment_cli.main(["--input_path", str(tmp_path / "in.png"), "--text_condition", SEG_CONCEPTS,
                           "--output_path", str(masks), "--seg_preset", "sam",
                           "--sam_checkpoint", str(root / "sam_tiny.pth"),
                           "--detector_dir", str(root / "groundingdino_tiny.pth"), "--detector", "dino"],
                          device="cpu")
    assert rc == 0 and capsys.readouterr().out.count("saved") == 2
    for name in SEG_CONCEPTS.split("+"):
        header, mask = port_image.read_png(str(masks / f"{name}.png"))
        assert (header["width"], header["height"], header["color_type"]) == (44, 36, 0)
        assert set(np.unique(mask).tolist()) <= {0, 255}
