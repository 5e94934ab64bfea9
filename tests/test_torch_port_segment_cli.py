"""The torch port's segmentation presets and CLIs on the CPU: ``sam-random``
end to end through the fusion CLI, the segment CLI's file contract, the
``--mask_dir`` round trip and its PNG route held against the JAX package's
loader, the GroundingDINO load and half-supplied-weights errors, and the port's
own PNG reader, writer and gray resize against PIL.
"""

import json
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tweediemix_tpu.cli import fusion_sampling as jax_cli
from tweediemix_tpu_torch.cli import fusion_sampling as cli
from tweediemix_tpu_torch.cli import segment as segment_cli
from tweediemix_tpu_torch.segmentation import (
    DETECTOR_DIR_ENV,
    SAM_CHECKPOINT_ENV,
    make_segment_fn,
)
from tweediemix_tpu_torch.utils import image as port_image

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PROMPT = "photo of a cat running+photo of a dog running+mountain background"
PROMPT_ORIG = "photo of a cat and a dog running"


def fusion_args(out, *extra):
    """The tiny preset at 128² (latent 16², images 32²: the tiny VAE
    upsamples twice), a short trajectory through the boundary step."""
    return ["--model_preset", "tiny", "--prompt", PROMPT, "--prompt_orig", PROMPT_ORIG,
            "--concepts", "cat+dog+mountain", "--modifier_token", "<cat1>+<dog1>+<mountain1>",
            "--seg_concepts", "a cat+a dog", "--output_path", str(out), "--n_timesteps", "4",
            "--t_cond", "0.5", "--resampling_steps", "0", "--jumping_steps", "1",
            "--guidance_scale", "0.8", "--resolution_h", "128", "--resolution_w", "128",
            "--seed", "5", *extra]


def read_timings(text):
    return json.loads(text.split("timings: ", 1)[1].splitlines()[0])


def test_fusion_cli_runs_sam_random_in_the_loop(tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(fusion_args(out, "--seg_preset", "sam-random"), device="cpu") == 0
    assert [f.name for f in out.glob("*.png")] == [f"{PROMPT_ORIG}_5.png"]
    header, pixels = port_image.read_png(str(out / f"{PROMPT_ORIG}_5.png"))
    assert (header["width"], header["height"], header["color_type"]) == (32, 32, 2)
    text = capsys.readouterr().out
    seg = json.loads(text.split("segmentation: ", 1)[1].splitlines()[0])
    assert [c for c, _ in seg["top_scores"]] == ["a cat", "a dog"]
    assert len(seg["mask_areas"]) == 2 and all(0.0 <= a <= 1.0 for a in seg["mask_areas"])
    timings = read_timings(text)
    assert timings["segment_s"] > 0 and 0 < timings["seg_load_s"] <= timings["load_s"]


def write_gradient_png(path, h=40, w=56):
    """An RGB PNG: a bright rectangle on a dark gradient."""
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.linspace(0, 120, w, dtype=np.uint8)[None]
    img[8:30, 10:40] = (230, 200, 180)
    port_image.write_png(str(path), img)
    return img


@pytest.mark.parametrize("preset", ["heuristic", "sam-random"])
def test_segment_cli_writes_one_gray_png_per_concept(tmp_path, capsys, preset):
    inp = tmp_path / "in.png"
    write_gradient_png(inp)
    out = tmp_path / "masks"
    assert segment_cli.main(["--input_path", str(inp), "--text_condition", "a cat+a dog",
                             "--output_path", str(out), "--seg_preset", preset], device="cpu") == 0
    assert sorted(f.name for f in out.iterdir()) == ["a cat.png", "a dog.png"]
    masks = []
    for name in ("a cat", "a dog"):
        header, pixels = port_image.read_png(str(out / f"{name}.png"))
        assert (header["width"], header["height"], header["color_type"]) == (56, 40, 0)
        assert set(np.unique(pixels)) <= {0, 255}
        masks.append(pixels[..., 0])
        with Image.open(out / f"{name}.png") as f:
            np.testing.assert_array_equal(np.asarray(f), pixels[..., 0])
    if preset == "heuristic":  # two vertical bands, an exact partition
        np.testing.assert_array_equal(masks[0].astype(int) + masks[1], 255)
    assert "saved" in capsys.readouterr().out


def test_segment_cli_matches_the_segmenter_it_wraps(tmp_path):
    """The written masks are the segmenter's masks at 0/255, on the image as
    PIL reads it."""
    inp = tmp_path / "in.png"
    write_gradient_png(inp)
    out = tmp_path / "masks"
    segment_cli.main(["--input_path", str(inp), "--text_condition", "a cat+a dog",
                      "--output_path", str(out), "--seg_preset", "sam-random"], device="cpu")
    seg = make_segment_fn("a cat+a dog", str(out), "sam-random", device="cpu")
    want = seg(torch.from_numpy(np.asarray(Image.open(inp).convert("RGB"), np.float32) / 255.0))
    for name, m in zip(("a cat", "a dog"), want):
        got = port_image.read_png(str(out / f"{name}.png"))[1][..., 0]
        np.testing.assert_array_equal(got, (m.numpy() * 255.0).astype(np.uint8))


def test_mask_dir_round_trip_through_both_clis(tmp_path, capsys):
    """The segment CLI's PNGs feed the fusion CLI's --mask_dir."""
    inp = tmp_path / "in.png"
    write_gradient_png(inp, 32, 32)
    masks = tmp_path / "masks"
    segment_cli.main(["--input_path", str(inp), "--text_condition", "a cat+a dog",
                      "--output_path", str(masks), "--seg_preset", "heuristic"], device="cpu")
    out = tmp_path / "out"
    assert cli.main(fusion_args(out, "--mask_dir", str(masks)), device="cpu") == 0
    assert [f.name for f in out.glob("*.png")] == [f"{PROMPT_ORIG}_5.png"]
    text = capsys.readouterr().out
    assert "segmentation: " not in text and "segment_s" not in read_timings(text)
    loaded = cli.load_fg_masks_from_dir(str(masks), "a cat+a dog", 128, 128)
    assert loaded.shape == (2, 128, 128) and loaded.dtype == np.float32


@pytest.mark.parametrize("shape, hw", [((64, 64), (64, 64)), ((32, 32), (128, 128)),
                                       ((100, 90), (64, 64)), ((50, 70), (128, 96)),
                                       ((33, 17), (20, 40))])
@pytest.mark.parametrize("kind", ["binary", "soft"])
def test_png_mask_route_matches_the_jax_loader(tmp_path, shape, hw, kind):
    """The same pixels as the port's ``<concept>.png`` and, for the JAX
    loader, under its ``<concept>.jpg`` name (PIL reads the file by its
    content): the loaded, resized masks are equal bit for bit."""
    rng = np.random.default_rng(shape[0])
    if kind == "binary":
        m = np.zeros(shape, np.uint8)
        m[shape[0] // 4 : 3 * shape[0] // 4, : shape[1] // 2] = 255
    else:
        m = np.asarray(Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).resize(
            (max(shape[1] // 4, 1), max(shape[0] // 4, 1))).resize(shape[::-1]))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir(), jax_dir.mkdir()
    for name, arr in (("a cat", m), ("a dog", 255 - m)):
        port_image.write_png(str(port_dir / f"{name}.png"), arr)
        port_image.write_png(str(jax_dir / f"{name}.jpg"), arr)
    got = cli.load_fg_masks_from_dir(str(port_dir), "a cat+a dog", *hw)
    want = jax_cli.load_fg_masks_from_dir(str(jax_dir), "a cat+a dog", *hw)
    np.testing.assert_array_equal(got, want)


def test_mask_dir_reads_the_jax_clis_jpgs_only_with_pil(tmp_path, monkeypatch):
    m = np.zeros((64, 64), np.uint8)
    m[:, :32] = 255
    Image.fromarray(m).save(tmp_path / "a cat.jpg")
    got = cli.load_fg_masks_from_dir(str(tmp_path), "a cat", 64, 64)
    np.testing.assert_array_equal(got, jax_cli.load_fg_masks_from_dir(str(tmp_path), "a cat", 64, 64))
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without PIL
    with pytest.raises(RuntimeError, match="only PNG files are read without PIL"):
        cli.load_fg_masks_from_dir(str(tmp_path), "a cat", 64, 64)
    port_image.write_png(str(tmp_path / "a cat.png"), m)  # the port's own format needs no PIL
    np.testing.assert_array_equal(cli.load_fg_masks_from_dir(str(tmp_path), "a cat", 64, 64), got)
    with pytest.raises(FileNotFoundError, match="neither a dog.png nor a dog.jpg"):
        cli.load_fg_masks_from_dir(str(tmp_path), "a cat+a dog", 64, 64)


@pytest.mark.parametrize("how", ["explicit", "a single file", "grounding config"])
def test_dino_detector_raises_and_never_falls_back(tmp_path, monkeypatch, how):
    """GroundingDINO asked for (an empty directory), or sniffed (an empty
    ``.pth``, a directory holding only a grounding ``config.json``): the
    load raises naming the checkpoint, before SAM loads, and the OWL-ViT
    loader never runs."""
    from tweediemix_tpu_torch.models import convert

    def no_owlvit(*args, **kwargs):
        raise AssertionError("fell back to the OWL-ViT loader")

    monkeypatch.setattr(convert, "load_detector", no_owlvit)
    det_dir = tmp_path / "det"
    det_dir.mkdir()
    detector = "auto"
    if how == "explicit":
        detector = "dino"
    elif how == "a single file":
        det_dir = tmp_path / "groundingdino_swinb_cogcoor.pth"
        det_dir.write_bytes(b"")
    else:
        (det_dir / "config.json").write_text(json.dumps({"model_type": "grounding-dino"}))
    with pytest.raises((FileNotFoundError, ValueError), match=re.escape(str(det_dir))):
        make_segment_fn("a cat", str(tmp_path), "sam", sam_checkpoint=str(tmp_path / "sam.pth"),
                        detector_dir=str(det_dir), detector=detector, device="cpu")


@pytest.mark.parametrize("given", ["--sam_checkpoint", "--detector_dir"])
def test_half_supplied_seg_weights_fail_fast(tmp_path, given):
    with pytest.raises(SystemExit, match=f"{given} was supplied without"):
        cli.main(fusion_args(tmp_path / "out", given, str(tmp_path / "w")), device="cpu")
    assert not (tmp_path / "out").exists() or not list((tmp_path / "out").iterdir())


def test_sam_preset_reads_the_environment_and_fails_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv(SAM_CHECKPOINT_ENV, raising=False)
    monkeypatch.delenv(DETECTOR_DIR_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="needs --sam_checkpoint"):
        make_segment_fn("a cat", str(tmp_path), "sam", device="cpu")
    with pytest.raises(FileNotFoundError, match="needs --sam_checkpoint"):
        cli.main(fusion_args(tmp_path / "out", "--seg_preset", "sam"), device="cpu")
    monkeypatch.setenv(SAM_CHECKPOINT_ENV, str(tmp_path / "no-such-sam.pth"))
    monkeypatch.setenv(DETECTOR_DIR_ENV, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no-such-sam.pth"):
        make_segment_fn("a cat", str(tmp_path), "sam", device="cpu")


# -- utils/image.py ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (1, 1), (5, 300, 3)])
def test_png_writer_round_trips_through_pil_and_the_reader(tmp_path, shape):
    a = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    port_image.write_png(path, a)
    with Image.open(path) as f:
        np.testing.assert_array_equal(np.asarray(f), a)
    header, pixels = port_image.read_png(path)
    assert header == dict(width=shape[1], height=shape[0], bit_depth=8,
                          color_type=0 if len(shape) == 2 else 2, interlace=0)
    np.testing.assert_array_equal(pixels.reshape(a.shape), a)


def _filtered_png(path, pixels, kinds):
    """A PNG whose row y uses filter kinds[y % len(kinds)] (the encoder's
    side of each filter, written here from the PNG specification)."""
    h, w, c = pixels.shape
    raw = pixels.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur, prev = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_every_row_filter(tmp_path, channels):
    px = np.random.default_rng(channels).integers(0, 256, (9, 11, channels), dtype=np.uint8)
    px[3:6] = 200  # runs where the predictors differ from the raw bytes
    path = str(tmp_path / "f.png")
    _filtered_png(path, px, kinds=[0, 1, 2, 3, 4])
    header, got = port_image.read_png(path)
    np.testing.assert_array_equal(got, px)
    with Image.open(path) as f:
        np.testing.assert_array_equal(np.asarray(f).reshape(px.shape), px)
    gray = port_image.to_gray(got)
    with Image.open(path) as f:
        np.testing.assert_array_equal(gray, np.asarray(f.convert("L")))
        np.testing.assert_array_equal(port_image.to_rgb(got), np.asarray(f.convert("RGB")))


def test_png_reader_rejects_corrupt_and_unsupported_files(tmp_path):
    path = str(tmp_path / "x.png")
    port_image.write_png(path, np.zeros((4, 4), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0xFF  # inside the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        port_image.read_png(str(tmp_path / "bad.png"))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="only 8-bit"):
        port_image.read_png(str(tmp_path / "deep.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        port_image.read_png(__file__)


@pytest.mark.parametrize("shape, hw", [((32, 32), (128, 128)), ((100, 90), (64, 64)),
                                       ((50, 70), (128, 96)), ((33, 17), (200, 5)),
                                       ((256, 256), (255, 257)), ((64, 64), (64, 64))])
def test_resize_gray_is_pils_default_resize(shape, hw):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    smooth = np.asarray(Image.fromarray(a).resize((max(shape[1] // 3, 1), max(shape[0] // 3, 1)))
                        .resize(shape[::-1]))
    for img in (a, smooth, (a > 128).astype(np.uint8) * 255):
        want = np.asarray(Image.fromarray(img).resize(hw[::-1]))
        np.testing.assert_array_equal(port_image.resize_gray(img, *hw), want)


def test_read_image_takes_png_without_pil_and_others_with_it(tmp_path, monkeypatch):
    rgb = np.random.default_rng(1).integers(0, 256, (6, 7, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "x.bmp")
    np.testing.assert_array_equal(port_image.read_image(str(tmp_path / "x.bmp")), rgb)
    port_image.write_png(str(tmp_path / "x.png"), rgb)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(port_image.read_image(str(tmp_path / "x.png")), rgb)
    with pytest.raises(RuntimeError, match="PIL is not installed"):
        port_image.read_image(str(tmp_path / "x.bmp"))
