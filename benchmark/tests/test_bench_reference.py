"""The plain reference against the port at tiny sizes on the CPU, in fp32:
the same seeded weights through the port's own loaders and into the
reference give the same noise predictions, images and W8A8 products."""

import os

import pytest
import torch

from benchmark import weights
from benchmark.reference import ops as ref_ops
from benchmark.reference.unet2d import UNet2D
from benchmark.reference.unet3d import UNet3D
from benchmark.reference.vae import VAE
from benchmark.tests.tiny import tiny_fusion, tiny_video

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
SEED = 2**33 + 7


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


@pytest.fixture(scope="module")
def fusion_parts():
    from benchmark.systems.fusion import CROSS_KV, program_configs

    _, wl, cfg = tiny_fusion()
    ref = meta(UNet2D, cfg["unet"])
    shapes = weights.shapes_of(ref)
    w = weights.draw(shapes, torch.float32, SEED, 100, "cpu")
    kv_shapes = {k: v for k, v in shapes.items() if CROSS_KV.search(k)}
    kvs = [weights.draw(kv_shapes, torch.float32, SEED, 100 + c, "cpu") for c in (1, 2, 3)]
    return cfg, wl, ref, w, kvs, program_configs


def unet_inputs(cfg, b=4):
    t = cfg["text"]
    g = torch.Generator().manual_seed(3)
    h = cfg["sampling"]["height"] // 8
    return (torch.randn((b, h, h, 4), generator=g), 501,
            0.1 * torch.randn((b, t["tokens"], t["dim"]), generator=g),
            0.1 * torch.randn((b, t["pooled_dim"]), generator=g),
            torch.tensor([[64.0, 64, 0, 0, 64, 64]]).expand(b, 6), torch.arange(b))


def test_draw_is_repeatable_and_scaled():
    shapes = {"a.weight": (64, 32, 3, 3), "a.bias": (64,), "n.weight": (64,)}
    one = weights.draw(shapes, torch.bfloat16, SEED, 5, "cpu")
    two = weights.draw(shapes, torch.bfloat16, SEED, 5, "cpu")
    other = weights.draw(shapes, torch.bfloat16, SEED + 1, 5, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert abs(float(one["a.weight"].float().std()) - (3 * 32 * 9) ** -0.5) < 0.01
    assert abs(float(one["n.weight"].float().mean()) - 1.0) < 0.05


def test_unet2d_matches_the_port_with_concept_slots(fusion_parts):
    from tweediemix_tpu_torch.models.convert import load_unet

    cfg, wl, ref, w, kvs, program_configs = fusion_parts
    ucfg, _, _ = program_configs(cfg, dict(wl, quant=None))
    port = load_unet(w, ucfg, "cpu", concept_kvs=kvs)
    ref.load_state_dict(w, assign=True)
    ref.set_concepts(kvs)
    args = unet_inputs(cfg)
    with torch.no_grad():
        want = ref(*args)
        got = port(*args)
    assert rel(got, want) < 1e-5
    # the concept slots matter: slot 0 for every row reads differently
    with torch.no_grad():
        base = ref(*args[:5], torch.zeros(4, dtype=torch.long))
    assert rel(base, want) > 1e-3


def test_w8a8_unet_matches_the_port(fusion_parts):
    from tweediemix_tpu_torch.models.convert import load_unet
    from tweediemix_tpu_torch.ops.quant import load_static_scales

    cfg, wl, ref, w, kvs, program_configs = fusion_parts
    ucfg, _, _ = program_configs(cfg, dict(wl, quant="int8"))
    port = load_unet(w, ucfg, "cpu", concept_kvs=kvs)
    ref = meta(UNet2D, cfg["unet"])
    ref.load_state_dict(w, assign=True)
    ref.set_concepts(kvs)
    sites = ref.mark_sites()
    args = unet_inputs(cfg)
    amax = {}

    def hook(m, inputs):
        amax[m.site] = max(amax.get(m.site, 0.0), float(inputs[0].abs().max()))

    hooks = [m.register_forward_pre_hook(hook) for m in ref.modules()
             if isinstance(m, ref_ops.Linear) and m.site]
    with torch.no_grad():
        ref(*args)
    for h in hooks:
        h.remove()
    table = {k: 1.25 * v for k, v in amax.items()}
    assert load_static_scales(port, table) == sites == len(table)
    ref_ops.set_precision(ref, ref_ops.Precision(amax=table))
    with torch.no_grad():
        want = ref(*args)
        got = port(*args)
        ref_ops.set_precision(ref, ref_ops.FP32)
        float_eps = ref(*args)
    assert rel(got, want) < 1e-4
    assert rel(float_eps, want) > 10 * rel(got, want)


def test_int8_attention_core_matches_the_ports_plain_version():
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention_int8_reference

    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((3, 300, 64), generator=g).to(torch.bfloat16) for _ in range(3))
    want = flash_attention_int8_reference(q, k, v).float()
    got = ref_ops.int8_attention(q, k, v, 64**-0.5)
    assert rel(got, want) < 1e-2  # the port rounds its output to bf16
    plain = ref_ops.softmax_attention(q, k, v, 64**-0.5)
    assert rel(got, plain) > rel(got, want)


@pytest.mark.parametrize("part", ["decode", "encode"])
def test_vae_matches_the_port(part):
    from tweediemix_tpu_torch.models.convert import load_vae
    from tweediemix_tpu_torch.models.vae import unscale_latents, postprocess_image
    from benchmark.systems.fusion import program_configs

    _, wl, cfg = tiny_fusion()
    _, vcfg, _ = program_configs(cfg, wl)
    ref = meta(VAE, cfg["vae"])
    w = weights.draw(weights.shapes_of(ref), torch.float32, SEED, 200, "cpu")
    port = load_vae(w, vcfg, "cpu")
    ref.load_state_dict(w, assign=True)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        if part == "decode":
            lat = torch.randn((2, 8, 8, 4), generator=g)
            got = postprocess_image(port.decode(unscale_latents(lat, port.config)))
            want = ref.decode_image(lat)
        else:
            img = torch.rand((1, 32, 32, 3), generator=g) * 2 - 1
            noise = torch.randn((1, 16, 16, 4), generator=g)
            mean, logvar = port.encode(img)
            got = (mean + torch.exp(0.5 * logvar) * noise) * port.config.scaling_factor
            want = ref.encode_sample(img, noise)
    assert rel(got, want) < 1e-5


def test_unet3d_matches_the_port():
    from tweediemix_tpu_torch.models.convert import load_unet3d
    from benchmark.systems.video import program_configs

    _, wl, cfg = tiny_video()
    ucfg, _, _ = program_configs(cfg, wl)
    ref = meta(UNet3D, cfg["unet"])
    w = weights.draw(weights.shapes_of(ref), torch.float32, SEED, 100, "cpu")
    port = load_unet3d(w, ucfg, "cpu")
    ref.load_state_dict(w, assign=True)
    g = torch.Generator().manual_seed(5)
    f, h = cfg["sampling"]["num_frames"], 16
    x = torch.randn((2, f, h, h, 4), generator=g)
    ctx = 0.1 * torch.randn((2, 8, 32), generator=g)
    il = torch.randn((2, f, h, h, 4), generator=g)
    emb = 0.1 * torch.randn((2, 1, 32), generator=g)
    fps = torch.full((2,), 8.0)
    for inject in (True, False):
        with torch.no_grad():
            got = port(x, 501, ctx, il, emb, fps, inject, inject, 0.7)
            want = ref(x, 501, ctx, il, emb, fps, inject, 0.7)
        assert rel(got, want) < 1e-5
