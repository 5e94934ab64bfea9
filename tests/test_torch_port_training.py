"""The torch port's training path against the JAX package on the CPU: the
flash attention's autograd function, the UNet's training options, the full
train step, the optimizers and schedules, the dataset and the trainable
selection at SDXL's topology.

Parameters come from numpy seeds and go into both packages (the port's
through ``models/convert.py``); the JAX train step's timestep and noise
draws are handed to the port's step. Tolerances are stated in each test:
fp32 throughout.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.schedulers.ddim import training_alphas_cumprod as jax_acp
from tweediemix_tpu.training import adam8bit as jax_adam8bit
from tweediemix_tpu.training import custom_diffusion as jax_cd
from tweediemix_tpu.training import lr_schedules as jax_lr
from tweediemix_tpu.training import trainer as jax_trainer
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models.convert import (
    clip_torch_name,
    convert_params,
    load_params,
    torch_layout,
    torch_name,
)
from tweediemix_tpu_torch.ops import attention as port_attention
from tweediemix_tpu_torch.ops.flash_attention import flash_attention_int8
from tweediemix_tpu_torch.schedulers.ddim import training_alphas_cumprod
from tweediemix_tpu_torch.training import adam8bit as port_adam8bit
from tweediemix_tpu_torch.training import custom_diffusion as port_cd
from tweediemix_tpu_torch.training import lr_schedules as port_lr
from tweediemix_tpu_torch.training import trainer as port_trainer

LR = 1e-3
MODIFIER_ID = 7


def numpy_params(abstract, seed):
    """A tree of the JAX model's shapes filled from a numpy seed (fan-in
    scaled kernels, norm scales near 1, LoRA up-factors' slot 0 zero as a
    fresh LoRA's are)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
        a = (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "lora_up" in name:
            a[0] = 0.0
        return a

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the flash attention's autograd function


def test_flash_attention_function_grads_match_jax_flash_bwd(monkeypatch):
    """A flash site with inputs that require a gradient runs through
    ``FlashAttention``; its dq/dk/dv equal the JAX package's ``_flash_bwd``
    (the per-BH vjp of ``_xla_attention``) within 1e-5 of each one's max,
    the forward equals ``_xla_attention`` within 1e-5. Under no_grad the
    kernel is called directly (no graph). With TWEEDIEMIX_FLASH_INT8=1 the
    forward is the int8 core and the backward the same float one
    (straight-through): equal gradients, bit for bit."""
    jax_attention = importlib.import_module("tweediemix_tpu.ops.attention")

    bh, s, dh = 2, 1024, 64
    assert port_attention.uses_flash(s, s, dh)
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((bh, s, dh)).astype(np.float32) for _ in range(4))
    scale = dh**-0.5
    want_out = jax_attention._xla_attention(q, k, v, scale)
    want = jax_attention._flash_bwd(scale, 256, 1024, 2, False, (q, k, v), g)

    def port_grads():
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = port_attention.attention(tq, tk, tv)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        out.backward(torch.from_numpy(g))
        return out.detach(), [t.grad for t in (tq, tk, tv)]

    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "0")
    out, grads = port_grads()
    assert rel_err(out, want_out) <= 1e-5
    for name, got, w in zip("qkv", grads, want):
        assert rel_err(got, w) <= 1e-5, name
    with torch.no_grad():
        direct = port_attention.attention(*(torch.from_numpy(a).requires_grad_() for a in (q, k, v)))
    assert direct.grad_fn is None

    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "1")
    out8, grads8 = port_grads()
    torch.testing.assert_close(out8, flash_attention_int8(*(torch.from_numpy(a) for a in (q, k, v))),
                               rtol=0, atol=0)
    assert rel_err(out8, want_out) > 1e-4  # the int8 forward really ran
    for got, ref in zip(grads8, grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the UNet's training options


def _micro_unet_case(seed=0, **kw):
    jcfg = jax_unet2d.UNetConfig.micro(**kw)
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    rng = np.random.default_rng(seed)
    x = (0.4 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    ctx = (0.2 * rng.standard_normal((2, 9, jcfg.cross_attention_dim))).astype(np.float32)
    pooled = (0.2 * rng.standard_normal((2, jcfg.pooled_projection_dim))).astype(np.float32)
    tids = np.tile(np.array([[64.0, 64, 0, 0, 64, 64]], np.float32), (2, 1))
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.int32(5), ctx, pooled,
                              tids)["params"]
    return model, numpy_params(abstract, seed), (x, ctx, pooled, tids)


def _port_unet_grads(params, inputs, **kw):
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(**kw), device="cpu")
    load_params(port, params)
    x, ctx, pooled, tids = (torch.from_numpy(a) for a in inputs)
    loss = (port(x, 501, ctx, pooled, tids) ** 2).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in port.named_parameters()])
    return loss.item(), dict(zip(names, grads)), port


def test_unet_training_options_grads_match_jax():
    """``detach_first_token_kv`` and ``remat`` against the JAX micro UNet's
    gradients of sum(eps²) (every parameter, converted to the port's
    layout; within 1e-4 of each leaf's max), the port's remat gradients
    equal to its plain ones (1e-6 of max, the
    ``test_unet_remat_grads_match`` counterpart), and the detach changes
    the K/V gradients."""
    kw = dict(detach_first_token_kv=True, remat=True)
    model, params, inputs = _micro_unet_case(**kw)
    x, ctx, pooled, tids = inputs

    def loss(p):
        return jnp.sum(model.apply({"params": p}, x, jnp.int32(501), ctx, pooled, tids) ** 2)

    want_loss, want_tree = jax.jit(jax.value_and_grad(loss))(params)
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(), device="cpu")
    want = convert_params(jax.tree_util.tree_map(np.asarray, want_tree), port)

    got_loss, got, _ = _port_unet_grads(params, inputs, **kw)
    assert got_loss == pytest.approx(float(want_loss), rel=1e-5)
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel_err(g, want[name]) <= 1e-4, name

    plain_loss, plain, _ = _port_unet_grads(params, inputs, detach_first_token_kv=True)
    assert plain_loss == pytest.approx(got_loss, rel=1e-6)
    for name, g in plain.items():
        assert rel_err(got[name], g) <= 1e-6, name
    _, undetached, _ = _port_unet_grads(params, inputs)
    kv = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    assert rel_err(undetached[kv], got[kv]) > 1e-3


# ---------------------------------------------------------------------------
# the full train step


def _train_case(freeze_model):
    lora = freeze_model == "lora"
    ukw = dict(cross_attention_dim=64, pooled_projection_dim=32,
               detach_first_token_kv=not lora, lora_slots=1 if lora else 0)
    c1, c2 = jax_clip.CLIPTextConfig.tiny(), jax_clip.CLIPTextConfig.tiny(projection_dim=32)
    junet = jax_unet2d.UNet2DConditionModel(jax_unet2d.UNetConfig.micro(**ukw))
    jte1, jte2 = jax_clip.CLIPTextModel(c1), jax_clip.CLIPTextModel(c2)
    ids = np.zeros((4, 77), np.int32)
    ids[:, 5] = 999
    ids[:2, 2] = MODIFIER_ID  # the instance rows' prompt holds the modifier token
    ids[:, 3] = np.arange(4) + 20
    key = jax.random.PRNGKey(0)
    abstract = {
        "unet": jax.eval_shape(junet.init, key, jnp.zeros((1, 8, 8, 4)), jnp.int32(1),
                               jnp.zeros((1, 77, 64)), jnp.zeros((1, 32)), jnp.zeros((1, 6))),
        "te1": jax.eval_shape(jte1.init, key, jnp.zeros((1, 77), jnp.int32)),
        "te2": jax.eval_shape(jte2.init, key, jnp.zeros((1, 77), jnp.int32)),
    }
    params = {k: numpy_params(a["params"], seed) for seed, (k, a) in enumerate(abstract.items())}
    rng = np.random.default_rng(5)
    mask = np.ones((4, 8, 8, 1), np.float32)
    mask[0, :3], mask[1, :, 5:] = 0.0, 0.0
    batch = dict(latents=rng.standard_normal((4, 8, 8, 4)).astype(np.float32), mask=mask,
                 ids_one=ids, ids_two=ids, is_prior=np.array([0.0, 0.0, 1.0, 1.0], np.float32))
    port_models = {
        "unet": port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(**ukw), device="cpu"),
        "te1": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(), device="cpu"),
        "te2": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(projection_dim=32),
                                       device="cpu"),
    }
    load_params(port_models["unet"], params["unet"])
    for k in ("te1", "te2"):
        load_params(port_models[k], params[k], name_fn=clip_torch_name)
    return (junet, jte1, jte2), params, port_models, batch


def _port_key(path):
    """A JAX full-tree path → the port's trainable key."""
    model, *rest = path
    return f"{model}/{(torch_name if model == 'unet' else clip_torch_name)(tuple(rest))}"


def _jax_draws(step, b, shape):
    r = jax.random.fold_in(jax.random.PRNGKey(1), step)
    rng_t, rng_n = jax.random.split(r)
    t = jax.random.randint(rng_t, (b,), 0, 1000)
    return np.asarray(t), np.asarray(jax.random.normal(rng_n, shape, jnp.float32))


@pytest.mark.parametrize("freeze_model", ["crossattn_kv", "lora"])
def test_full_train_step_matches_jax(freeze_model):
    """Three steps of ``make_full_train_step`` (fp32; the micro UNet with
    the tiny towers, a modifier token, prior preservation) against the JAX
    step with its t and noise handed over: the loss within 1e-5, each
    gradient (row-masked, before the clip) within 1e-4 of its max, each
    trainable leaf within 0.1·lr (AdamW's first steps move an element by
    about lr whatever its gradient's size, so a gradient near zero carries
    its rounding noise into the leaf at that scale; 0.018·lr is the largest
    seen) and within 1e-3·lr on the median element; frozen leaves
    bit-equal."""
    (junet, jte1, jte2), params, models, batch = _train_case(freeze_model)
    jcfg = jax_cd.TrainConfig(learning_rate=LR, freeze_model=freeze_model)
    jmask = jax_trainer.full_trainable_mask(params, freeze_model, True)
    recorded = []

    def record(updates, state, params=None):
        jax.debug.callback(lambda g: recorded.append(jax.tree_util.tree_map(np.asarray, g)),
                           updates)
        return updates, state

    jopt = optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(), record),
                       jax_trainer.make_full_optimizer(jcfg, jmask))
    rm = jax_trainer.embedding_row_mask(1000, [MODIFIER_ID])
    tids = np.array([[64.0, 64, 0, 0, 64, 64]], np.float32)
    jstep = jax.jit(jax_trainer.make_full_train_step(junet, jte1, jte2, jcfg, jax_acp(), jopt,
                                                     rm, rm, tids, mask=jmask))
    jstate = jax_trainer.FullTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                        opt_state=jopt.init(jax_trainer.trainable_subset(params,
                                                                                         jmask)))

    pcfg = port_cd.TrainConfig(learning_rate=LR, freeze_model=freeze_model)
    pmask = port_trainer.full_trainable_mask(models, freeze_model, True)
    before = {f"{k}/{n}": p.detach().clone() for k, m in models.items()
              for n, p in m.named_parameters()}
    pparams = port_trainer.promote_trainable_to_fp32(models, pmask)
    want_keys = {_port_key(p) for p, on in traverse_util.flatten_dict(jmask).items() if on}
    assert set(pparams) == want_keys
    state = port_trainer.FullTrainState(pparams, port_trainer.make_full_optimizer(pcfg, pparams))
    prm = port_trainer.embedding_row_mask(1000, [MODIFIER_ID])
    pstep = port_trainer.make_full_train_step(models["unet"], models["te1"], models["te2"], pcfg,
                                              training_alphas_cumprod(), prm, prm,
                                              torch.from_numpy(tids))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("ids_one", "ids_two"):
        pbatch[k] = pbatch[k].long()

    for step in range(3):
        jstate, jmetrics = jstep(jstate, batch, jax.random.PRNGKey(1))
        t, noise = _jax_draws(step, 4, batch["latents"].shape)
        metrics = pstep(state, pbatch, timesteps=torch.from_numpy(t).long(),
                        noise=torch.from_numpy(noise))
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
        assert float(metrics["prior_loss"]) == pytest.approx(float(jmetrics["prior_loss"]),
                                                            rel=1e-5)
        jgrads = recorded[step]
        assert {_port_key(p) for p in jgrads} == set(state.grads)
        for path, g in jgrads.items():
            got = state.grads[_port_key(path)]
            assert rel_err(got, torch_layout(path, g)) <= 1e-4, (step, path)
    assert state.step == 3

    jflat = traverse_util.flatten_dict(jstate.params)
    for path, on in traverse_util.flatten_dict(jmask).items():
        if not on:
            continue
        got = state.params[_port_key(path)].detach().numpy()
        want = torch_layout(path, np.asarray(jflat[path]))
        diff = np.abs(got - want)
        assert diff.max() <= 0.1 * LR, path
        assert np.median(diff) <= 1e-3 * LR, path
    moved = 0
    for key, p in before.items():
        model, name = key.split("/", 1)
        now = dict(models[model].named_parameters()).get(name)
        if key in pparams:
            moved += not torch.equal(pparams[key].detach(), p)
        else:
            assert now is not None and torch.equal(now, p), key
    assert moved == len(pparams)


def test_bf16_masters_compute_in_the_module_dtype():
    """Under a bf16 bulk a trainable weight becomes an fp32 master that the
    module reads as bf16, with an fp32 gradient; a LoRA factor is fp32
    outright; frozen weights stay bf16 and take no gradient; the delta's
    K/V and modifier rows are the fp32 masters."""
    models = {
        "unet": port_unet2d.UNet2DConditionModel(
            port_unet2d.UNetConfig.micro(cross_attention_dim=64, dtype=torch.bfloat16,
                                         lora_slots=1), device="cpu"),
        "te1": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(dtype=torch.bfloat16),
                                       device="cpu"),
        "te2": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(dtype=torch.bfloat16,
                                                                      projection_dim=32),
                                       device="cpu"),
    }
    kv = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    mask = port_trainer.full_trainable_mask(models, "crossattn_kv", True)
    mask["unet"]["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q_lora_down"] = True
    params = port_trainer.promote_trainable_to_fp32(models, mask)
    attn2 = models["unet"].get_submodule("down_blocks.0.attentions.0.transformer_blocks.0.attn2")
    assert params[f"unet/{kv}"].dtype == torch.float32
    assert attn2.to_k.weight.dtype == torch.bfloat16
    assert torch.equal(attn2.to_k.weight, params[f"unet/{kv}"].to(torch.bfloat16))
    lora = params["unet/down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q_lora_down"]
    assert lora.dtype == torch.float32 and lora.requires_grad
    assert attn2.to_q.weight.dtype == torch.bfloat16 and not attn2.to_q.weight.requires_grad
    table = models["te1"].text_model.embeddings.token_embedding
    assert table.weight.dtype == torch.bfloat16
    ctx = attn2.to_k(torch.randn(1, 3, 64, dtype=torch.bfloat16))
    assert ctx.dtype == torch.bfloat16
    ctx.float().sum().backward()
    assert params[f"unet/{kv}"].grad.dtype == torch.float32
    unet_delta, tok1, tok2 = port_trainer.extract_delta(params, ["<a>"], [MODIFIER_ID], [3])
    assert unet_delta[kv].dtype == torch.float32
    assert torch.equal(unet_delta[kv], params[f"unet/{kv}"].detach())
    lora_name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.processor.to_q_lora.down.weight"
    assert tuple(unet_delta[lora_name].shape) == (4, 32)
    assert torch.equal(tok1["<a>"], params["te1/" + port_trainer.TOKEN_TABLE].detach()[MODIFIER_ID])
    sd = port_trainer.plain_state_dict(models["te1"])
    assert sd[port_trainer.TOKEN_TABLE].dtype == torch.float32
    assert set(sd) == {n for n, _ in port_clip.CLIPTextModel(
        port_clip.CLIPTextConfig.tiny(), device="meta").named_parameters()}


def test_lora_from_a_checkpoint_learns_only_with_drawn_down_factors():
    """A LoRA UNet filled from a checkpoint holds zero factors (slot 0 of
    ``stack_lora_params(params, [])`` in the JAX package too): every
    gradient of every factor is then zero, so the JAX CLI's SDXL LoRA run
    never moves. ``init_lora_down`` draws the down factors from N(0, 1/r)
    (the reference's LoRALinearLayer) and the up factors then learn."""
    from tweediemix_tpu.concepts.delta import stack_lora_params
    from tweediemix_tpu_torch.cli.train import init_lora_down
    from tweediemix_tpu_torch.models.convert import load_unet

    model, params, inputs = _micro_unet_case()
    x, ctx, pooled, tids = inputs
    stacked = stack_lora_params(params, [], rank=4)
    jmodel = jax_unet2d.UNet2DConditionModel(jax_unet2d.UNetConfig.micro(lora_slots=1))
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, x, 501, ctx, pooled, tids) ** 2)))(stacked)
    lora_grads = [np.abs(np.asarray(g)).max() for path, g in traverse_util.flatten_dict(grads).items()
                  if "_lora_" in path[-1]]
    assert lora_grads and max(lora_grads) == 0.0

    base = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(), device="cpu")
    load_params(base, params)
    from tweediemix_tpu_torch.models.convert import checkpoint_state_dict

    unet = load_unet(checkpoint_state_dict(base), port_unet2d.UNetConfig.micro(lora_slots=1), "cpu")
    init_lora_down(unet, 4, torch.Generator().manual_seed(0))
    downs = {n: p for n, p in unet.named_parameters() if n.endswith("_lora_down")}
    ups = {n: p for n, p in unet.named_parameters() if n.endswith("_lora_up")}
    assert all(p.abs().max() > 0 for p in downs.values())
    assert all(torch.equal(p, torch.zeros_like(p)) for p in ups.values())
    std = torch.cat([p.flatten() for p in downs.values()]).std().item()
    assert std == pytest.approx(1 / 4, rel=0.1)
    x, ctx, pooled, tids = (torch.from_numpy(a) for a in inputs)
    out = unet(x, 501, ctx, pooled, tids)
    up_grads = torch.autograd.grad((out**2).sum(), list(ups.values()))
    assert all(g.abs().max() > 0 for g in up_grads)


# ---------------------------------------------------------------------------
# optimizers and schedules


def test_blockwise_quantisation_matches_jax():
    """``quantize_blockwise`` and its inverses (linear and sqrt-domain)
    equal the JAX package's: codes bit for bit, scales and values within
    1e-7 relative."""
    rng = np.random.default_rng(0)
    for n in (256, 1000, 3 * 256 + 7):
        x = (rng.standard_normal(n) * np.logspace(-6, 1, n)).astype(np.float32)
        x[:5] = 0.0
        want_q, want_s = jax_adam8bit.quantize_blockwise(jnp.asarray(x))
        got_q, got_s = port_adam8bit.quantize_blockwise(torch.from_numpy(x))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7)
        np.testing.assert_allclose(
            port_adam8bit.dequantize_blockwise(got_q, got_s, (n,)).numpy(),
            np.asarray(jax_adam8bit.dequantize_blockwise(want_q, want_s, (n,))), rtol=1e-6)
        v = np.abs(x)
        wq, ws = jax_adam8bit.quantize_v_blockwise(jnp.asarray(v))
        gq, gs = port_adam8bit.quantize_v_blockwise(torch.from_numpy(v))
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_allclose(port_adam8bit.dequantize_v_blockwise(gq, gs, (n,)).numpy(),
                                   np.asarray(jax_adam8bit.dequantize_v_blockwise(wq, ws, (n,))),
                                   rtol=1e-6)


def _grad_sequence(shapes, n, seed=0):
    rng = np.random.default_rng(seed)
    seq = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(n)]
    for g in seq[1]:
        g *= 40.0  # a step above the clip norm
    return seq


@pytest.mark.parametrize("use_8bit_adam", [False, True])
@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_full_optimizer_matches_jax(use_8bit_adam, accumulation_steps):
    """Clip + AdamW (or AdamW8bit) with a warmup schedule, under
    accumulation 1 and 2, on the same gradients over 6 micro steps (one
    above the clip norm) as the JAX package's ``make_full_optimizer``: every
    parameter within 1e-6 after every micro step."""
    shapes = [(300,), (16, 40)]
    rng = np.random.default_rng(1)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched_kw = dict(name="linear", base_lr=1e-2, warmup_steps=2, total_steps=6)
    jcfg = jax_cd.TrainConfig(learning_rate=jax_lr.get_lr_schedule(**sched_kw),
                              use_8bit_adam=use_8bit_adam)
    pcfg = port_cd.TrainConfig(learning_rate=port_lr.get_lr_schedule(**sched_kw),
                               use_8bit_adam=use_8bit_adam)
    jopt = jax_trainer.make_full_optimizer(jcfg, None, accumulation_steps)
    jparams = [jnp.asarray(a) for a in init]
    jstate = jopt.init(jparams)
    pparams = {str(i): torch.nn.Parameter(torch.from_numpy(a.copy())) for i, a in enumerate(init)}
    popt = port_trainer.make_full_optimizer(pcfg, pparams, accumulation_steps)
    for grads in _grad_sequence(shapes, 6):
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(pparams.values(), grads):
            p.grad = torch.from_numpy(g)
        popt.step()
        for p, w in zip(pparams.values(), jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_accumulation_equals_one_large_batch():
    """Two micro steps of half a batch at accumulation 2 hand the inner
    optimizer the gradients that one step of the whole batch at
    accumulation 1 hands it (after the clip), within 1e-5 of their max."""
    _, _, _, batch = _train_case("crossattn_kv")

    def inner_grads(halves, accumulation_steps):
        _, _, models, _ = _train_case("crossattn_kv")
        cfg = port_cd.TrainConfig(learning_rate=LR)
        params = port_trainer.promote_trainable_to_fp32(
            models, port_trainer.full_trainable_mask(models, "crossattn_kv", True))
        state = port_trainer.FullTrainState(
            params, port_trainer.make_full_optimizer(cfg, params, accumulation_steps))
        seen = []
        inner_step = state.optimizer.inner.step
        state.optimizer.inner.step = lambda: (seen.append([p.grad.clone() for p in params.values()]),
                                              inner_step())
        rm = port_trainer.embedding_row_mask(1000, [MODIFIER_ID])
        step = port_trainer.make_full_train_step(
            models["unet"], models["te1"], models["te2"], cfg, training_alphas_cumprod(), rm, rm,
            torch.tensor([[64.0, 64, 0, 0, 64, 64]]))
        t, noise = _jax_draws(0, 4, batch["latents"].shape)
        for rows in halves:
            part = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
            for k in ("ids_one", "ids_two"):
                part[k] = part[k].long()
            step(state, part, timesteps=torch.from_numpy(t[rows]).long(),
                 noise=torch.from_numpy(noise[rows]))
        assert len(seen) == 1
        return seen[0]

    whole = inner_grads([np.arange(4)], 1)
    halves = inner_grads([np.array([0, 2]), np.array([1, 3])], 2)
    for a, b in zip(halves, whole):
        assert rel_err(a, b) <= 1e-5


def test_lr_schedules_match_jax():
    """Every schedule, value for value over the steps 0..total+5, within
    1e-6 relative (the JAX package evaluates in fp32)."""
    for name in port_lr.LR_SCHEDULER_NAMES:
        for kw in (dict(warmup_steps=0, total_steps=10), dict(warmup_steps=3, total_steps=12),
                   dict(warmup_steps=4, total_steps=9, num_cycles=2.0, power=2.0)):
            want = jax_lr.get_lr_schedule(name, 1e-3, **kw)
            got = port_lr.get_lr_schedule(name, 1e-3, **kw)
            for step in range(kw["total_steps"] + 6):
                assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), \
                    (name, kw, step)
    with pytest.raises(ValueError, match="unknown"):
        port_lr.get_lr_schedule("cyclic", 1e-3)
    with pytest.raises(ValueError, match="lr_end"):
        port_lr.get_lr_schedule("polynomial", 1e-8, total_steps=5)


# ---------------------------------------------------------------------------
# trainable selection at SDXL's topology (shapes only)


@pytest.mark.parametrize("freeze_model,train_text_encoder",
                         [("crossattn_kv", False), ("crossattn", False), ("lora", True)])
def test_trainable_selection_matches_jax_at_sdxl_topology(freeze_model, train_text_encoder):
    """``full_trainable_mask`` on the port's SDXL UNet and towers (built on
    ``meta``) names the JAX package's trainable leaves of ``jax.eval_shape``
    of the SDXL tree, mapped to the port's names, with the same shapes."""
    lora = dict(lora_slots=1) if freeze_model == "lora" else {}
    S = jax.ShapeDtypeStruct
    key = jax.random.PRNGKey(0)
    jcfg = jax_unet2d.UNetConfig.sdxl(**lora)
    c1, c2 = jax_clip.CLIPTextConfig.sdxl_text_encoder(), jax_clip.CLIPTextConfig.sdxl_text_encoder_2()
    ids = S((1, 77), jnp.int32)
    shapes = {
        "unet": jax.eval_shape(jax_unet2d.UNet2DConditionModel(jcfg).init, key,
                               S((1, 16, 16, 4), jnp.float32), S((), jnp.int32),
                               S((1, 77, 2048), jnp.float32), S((1, 1280), jnp.float32),
                               S((1, 6), jnp.float32))["params"],
        "te1": jax.eval_shape(jax_clip.CLIPTextModel(c1).init, key, ids)["params"],
        "te2": jax.eval_shape(jax_clip.CLIPTextModel(c2).init, key, ids)["params"],
    }
    jmask = jax_trainer.full_trainable_mask(shapes, freeze_model, True, train_text_encoder)
    flat = traverse_util.flatten_dict(shapes)
    want = {}
    for path, on in traverse_util.flatten_dict(jmask).items():
        if on:
            shape = flat[path].shape
            want[_port_key(path)] = shape[::-1] if path[-1] == "kernel" else shape
    models = {
        "unet": port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.sdxl(**lora), device="meta"),
        "te1": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.sdxl_text_encoder(), device="meta"),
        "te2": port_clip.CLIPTextModel(port_clip.CLIPTextConfig.sdxl_text_encoder_2(),
                                       device="meta"),
    }
    pmask = port_trainer.full_trainable_mask(models, freeze_model, True, train_text_encoder)
    got = {}
    for model, names in pmask.items():
        named = dict(models[model].named_parameters())
        got.update({f"{model}/{n}": tuple(named[n].shape) for n, on in names.items() if on})
    assert got == want
    # SDXL has 70 cross-attentions: K and V each, or five attn2 leaves each;
    # plus the two token tables
    expected = {"crossattn_kv": 70 * 2 + 2, "crossattn": 70 * 5 + 2}.get(freeze_model)
    if expected is not None:
        assert len(got) == expected


# ---------------------------------------------------------------------------
# the UNet-only step and the noise schedule


def test_training_noise_schedule_matches_jax():
    """``training_alphas_cumprod`` within 1e-7 and ``add_noise`` within
    1e-6 of the JAX package's."""
    from tweediemix_tpu.schedulers.ddim import add_noise as jax_add_noise
    from tweediemix_tpu_torch.schedulers.ddim import add_noise

    want = np.asarray(jax_acp())
    got = training_alphas_cumprod()
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999])
    np.testing.assert_allclose(
        add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t), got).numpy(),
        np.asarray(jax_add_noise(x0, noise, t, want)), rtol=1e-6, atol=1e-6)


def test_unet_only_train_step_matches_jax():
    """``custom_diffusion.make_train_step`` (precomputed text embeddings,
    crossattn with prior preservation) against the JAX package's for two
    steps with its t and noise handed over: the loss within 1e-5, the
    trainable leaves within 0.1·lr, the frozen ones bit-equal."""
    model, params, (x, ctx, pooled, tids) = _micro_unet_case(seed=2, detach_first_token_kv=True)
    batch = dict(latents=x, mask=np.ones((2, 8, 8, 1), np.float32), ctx=ctx, pooled=pooled,
                 time_ids=tids, is_prior=np.array([0.0, 1.0], np.float32))
    jcfg = jax_cd.TrainConfig(learning_rate=LR, freeze_model="crossattn")
    mask = jax_cd.trainable_mask(params, "crossattn")
    jopt = jax_cd.make_optimizer(jcfg, mask)
    jstep = jax.jit(jax_cd.make_train_step(model, jcfg, jax_acp(), jopt))
    jstate = jax_cd.init_state(params, jopt)

    port = port_unet2d.UNet2DConditionModel(
        port_unet2d.UNetConfig.micro(detach_first_token_kv=True), device="cpu")
    load_params(port, params)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    pmask = port_cd.trainable_mask(port, "crossattn")
    trainable = [p for n, p in port.named_parameters() if pmask[n]]
    for n, p in port.named_parameters():
        p.requires_grad_(pmask[n])
    pcfg = port_cd.TrainConfig(learning_rate=LR, freeze_model="crossattn")
    pstep = port_cd.make_train_step(port, pcfg, training_alphas_cumprod(),
                                    port_cd.make_optimizer(pcfg, trainable))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(2):
        jstate, jmetrics = jstep(jstate, batch, jax.random.PRNGKey(1))
        r = jax.random.fold_in(jax.random.PRNGKey(1), step)
        rng_t, rng_n = jax.random.split(r)
        t = np.asarray(jax.random.randint(rng_t, (2,), 0, 1000))
        noise = np.asarray(jax.random.normal(rng_n, x.shape, jnp.float32))
        metrics = pstep(pbatch, timesteps=torch.from_numpy(t).long(),
                        noise=torch.from_numpy(noise))
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    want = convert_params(jax.tree_util.tree_map(np.asarray, jstate.params), port)
    for n, p in port.named_parameters():
        if pmask[n]:
            assert not torch.equal(p.detach(), before[n]), n
            assert (p.detach() - want[n]).abs().max().item() <= 0.1 * LR, n
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert sum(pmask.values()) == 4 * 5  # four cross-attentions, five attn2 leaves each
