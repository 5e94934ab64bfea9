"""The torch port stands alone: it never loads JAX or the JAX package, and
its entry points never fall back to the CPU when CUDA was asked for."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import tweediemix_tpu_torch

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "tweediemix_tpu_torch")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="tweediemix_tpu_torch."))


def _port_sources():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    for name in ("fusion.pipeline", "video.pipeline", "utils.tokenizer", "models.clip",
                 "concepts.delta", "segmentation", "cli.fusion_sampling", "segmentation.sam",
                 "segmentation.detector", "segmentation.lang_sam", "cli.segment", "utils.image",
                 "cli.run_video", "cli.train", "training.custom_diffusion", "training.trainer",
                 "training.optim", "training.adam8bit", "training.lr_schedules", "training.data",
                 "training.augment", "training.class_gen", "training.retrieve", "utils.logging",
                 "models.swin", "models.bert", "models.dino", "cli.serve", "evaluation",
                 "cli.evaluate", "utils.profiling", "segmentation.viz", "cli.app",
                 "tools.calibrate_quant", "parallel", "parallel.mesh", "utils.compile_cache"):
        assert f"tweediemix_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax'))\n"
        "             or m == 'tweediemix_tpu' or m.startswith('tweediemix_tpu.')\n"
        "             or m.split('.')[0] in ('transformers', 'safetensors', 'PIL', 'cv2'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_do_not_name_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b|\btweediemix_tpu\.", re.M)
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for m in pattern.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_port_imports_no_transformers_or_safetensors_and_pil_only_to_read_masks():
    """The GPU machine has neither transformers, safetensors nor cv2 and
    does not promise PIL: the port imports the first three nowhere, and PIL
    only inside ``utils/image.py``'s reader of formats other than PNG (the
    fusion CLI's --mask_dir JPGs, the segment and video CLIs' inputs); the
    video path's GIF writer is the port's own."""
    offenders = []
    for path in _port_sources():
        if not path.endswith(".py"):
            continue
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        scopes = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                scopes[child] = node if isinstance(node, ast.FunctionDef) else scopes.get(node)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                where = f"{os.path.relpath(path, REPO)}:{node.lineno} {name}"
                if top in ("transformers", "safetensors", "cv2"):
                    offenders.append(where)
                elif top == "PIL":
                    scope = scopes.get(node)
                    if scope is None or scope.name != "_read_with_pil":
                        offenders.append(where)
    assert not offenders, offenders


def test_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the entry points would run there")
    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig, FusionSampler
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from tweediemix_tpu_torch.schedulers.ddim import DDIMTable
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline, VideoConfig

    fcfg = FusionConfig(n_timesteps=10, height=64, width=64)
    with pytest.raises(RuntimeError, match="cuda"):
        UNet2DConditionModel(UNetConfig.micro())
    with pytest.raises(RuntimeError, match="cuda"):
        AutoencoderKL(VAEConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        TweedieMixPipeline.from_random_weights(UNetConfig.micro(), VAEConfig.tiny(), fcfg)
    unet = UNet2DConditionModel(UNetConfig.micro(), device="cpu")
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TweedieMixPipeline(unet, vae, fcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        FusionSampler(DDIMTable.create(n_steps=10), fcfg, None).init_latent(0)
    vcfg = VideoConfig(num_frames=2, height=16, width=16, latent_factor=2, n_timesteps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        UNet3DConditionModel(UNet3DConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        I2VPipeline.from_random_weights(UNet3DConfig.tiny(), VAEConfig.tiny(), vcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        I2VPipeline(vcfg, UNet3DConditionModel(UNet3DConfig.tiny(), device="cpu"), vae)
    from tweediemix_tpu_torch.cli.fusion_sampling import main
    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel

    with pytest.raises(RuntimeError, match="cuda"):
        CLIPTextModel(CLIPTextConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_preset", "tiny", "--concepts", "a+b", "--modifier_token", "<a>+<b>"])
    from tweediemix_tpu_torch.cli import run_video

    with pytest.raises(RuntimeError, match="cuda"):
        run_video.main(["--model_preset", "tiny", "--image", "x.png", "--prompt", "a cat"])
    from tweediemix_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--model_preset", "tiny", "--instance_data_dir", "inst",
                    "--instance_prompt", "a <new1> cat"])
    from tweediemix_tpu_torch.cli import segment
    from tweediemix_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from tweediemix_tpu_torch.segmentation import make_segment_fn
    from tweediemix_tpu_torch.segmentation.detector import DetectorConfig, TextBoxDetector
    from tweediemix_tpu_torch.segmentation.lang_sam import LangSAM
    from tweediemix_tpu_torch.segmentation.sam import SAM, SAMConfig

    from tweediemix_tpu_torch.models.bert import BertConfig, BertTextEncoder
    from tweediemix_tpu_torch.models.convert import load_dino
    from tweediemix_tpu_torch.models.dino import DinoConfig, GroundingDino
    from tweediemix_tpu_torch.models.swin import SwinBackbone, SwinConfig

    for build in (lambda: SAM(SAMConfig.tiny()), lambda: TextBoxDetector(DetectorConfig.tiny()),
                  lambda: CLIPVisionModel(CLIPVisionConfig.tiny()), LangSAM.random_init,
                  lambda: make_segment_fn("a cat", "out", "sam-random"),
                  lambda: segment.main(["--input_path", "x.png", "--text_condition", "a cat",
                                        "--output_path", "out"]),
                  lambda: GroundingDino(DinoConfig.tiny()), lambda: SwinBackbone(SwinConfig.tiny()),
                  lambda: BertTextEncoder(BertConfig.tiny()),
                  lambda: load_dino("groundingdino_swinb_cogcoor.pth", DinoConfig.tiny()),
                  lambda: LangSAM.from_pretrained("sam.pth", "groundingdino_swinb_cogcoor.pth",
                                                  detector="dino"),
                  lambda: make_segment_fn("a cat", "out", "sam", sam_checkpoint="sam.pth",
                                          detector_dir="groundingdino_swinb_cogcoor.pth")):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    import io

    from tweediemix_tpu_torch.cli import app, evaluate, serve
    from tweediemix_tpu_torch.evaluation import CLIPScorer
    from tweediemix_tpu_torch.tools import calibrate_quant

    fusion_flags = ["--model_preset", "tiny", "--concepts", "a+b", "--modifier_token", "<a>+<b>"]
    for build in (lambda: serve.main(fusion_flags, stdin=io.StringIO('{"seed": 1}\n'),
                                     stdout=io.StringIO()),
                  lambda: evaluate.main(["--images", "gen", "--prompt", "a cat",
                                         "--model_preset", "tiny"]),
                  CLIPScorer.tiny, lambda: CLIPScorer.from_pretrained("clip"),
                  lambda: app.make_predict_fn("sam-random"),
                  lambda: calibrate_quant.main(["--micro", "--out", "scales.json"])):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    from tweediemix_tpu_torch.parallel.mesh import init_distributed, make_mesh

    # default devices are CUDA ones: never a CPU mesh or a gloo group in their place
    for build in (make_mesh, lambda: make_mesh({"dp": 2}),
                  lambda: init_distributed("127.0.0.1:1", 1, 0),
                  lambda: train.main(["--model_preset", "tiny", "--instance_data_dir", "inst",
                                      "--instance_prompt", "a <new1> cat", "--dp_devices", "2"]),
                  lambda: run_video.main(["--model_preset", "tiny", "--image", "x.png",
                                          "--prompt", "a cat", "--mesh_devices", "2"])):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    assert not torch.distributed.is_initialized()


def test_video_cli_runs_without_pil(tmp_path, monkeypatch, capsys):
    """From a PNG to a GIF with PIL unimportable, as on a machine without
    it: the port reads the picture and writes the clip itself."""
    from tweediemix_tpu_torch.cli import run_video
    from tweediemix_tpu_torch.utils.image import read_gif, write_png

    monkeypatch.setitem(sys.modules, "PIL", None)
    png = str(tmp_path / "fused.png")
    write_png(png, torch.randint(0, 256, (24, 20, 3), dtype=torch.uint8).numpy())
    out = str(tmp_path / "clip.gif")
    rc = run_video.main(["--model_preset", "tiny", "--image", png, "--prompt", "a cat",
                         "--output", out, "--num_frames", "2", "--height", "32", "--width", "32",
                         "--n_timesteps", "2"], device="cpu")
    assert rc == 0 and "saved" in capsys.readouterr().out
    header, frames = read_gif(out)
    assert frames.shape == (2, 32, 32, 3) and header["loop"] == 0


def test_training_cli_runs_without_pil(tmp_path, monkeypatch, capsys):
    """From PNG instance images to a delta with PIL unimportable, class
    images generated and read back by the port itself."""
    from tweediemix_tpu_torch.cli import train
    from tweediemix_tpu_torch.utils.image import write_png

    monkeypatch.setitem(sys.modules, "PIL", None)
    inst = tmp_path / "inst"
    inst.mkdir()
    write_png(str(inst / "0.png"), torch.randint(0, 256, (40, 30, 3), dtype=torch.uint8).numpy())
    out = tmp_path / "ckpt"
    rc = train.main(["--model_preset", "tiny", "--instance_data_dir", str(inst),
                     "--instance_prompt", "a <new1> cat", "--class_data_dir", str(tmp_path / "cls"),
                     "--class_prompt", "a cat", "--with_prior_preservation",
                     "--num_class_images", "1", "--modifier_token", "<new1>",
                     "--resolution", "32", "--max_train_steps", "2", "--output_dir", str(out)],
                    device="cpu")
    assert rc == 0 and "saved" in capsys.readouterr().out
    assert (out / "delta-2.bin").exists() and (tmp_path / "cls" / "00000.png").exists()


def test_torch_threads_are_capped_per_xdist_worker():
    """Each xdist worker runs torch on its share of the host's cores, and
    every port test file applies that cap when it is imported (each worker
    imports them all): uncapped, the workers' intra-op threads spin against
    each other and against XLA's."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, os.cpu_count() // workers)
    cap = ('torch.set_num_threads(max(1, os.cpu_count() // '
           'int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))')
    files = sorted(f for f in os.listdir(os.path.join(REPO, "tests")) if f.startswith("test_torch_port_"))
    uncapped = [f for f in files if cap not in open(os.path.join(REPO, "tests", f), encoding="utf-8").read()]
    assert len(files) >= 21 and not uncapped, uncapped


def test_package_exports_version_and_ddim_table():
    assert tweediemix_tpu_torch.__version__
    assert tweediemix_tpu_torch.DDIMTable.create(50).n_steps == 50
