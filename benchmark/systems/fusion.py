"""Driver of the fusion configurations: TweedieMix multi-concept sampling on
SDXL through ``tweediemix_tpu_torch`` (``TweedieMixPipeline.sample``, which
ends in the fp32 decode and a CUDA synchronise).

Set-up draws the weights, the text embeddings and the masks from the seed
(``benchmark/weights.py``), hands them to the program's own loaders
(``models/convert.py``: the program derives its merged q/k/v, concept
stacks and int8 weights there), and for a W8A8 cell calibrates the static
activation scales on the plain reference and hands the table to the
program. The weights are then freed, and drawn again for the reference
after the window.

Every UNet call of a request is recorded (its latent input, its noise
prediction) into a reservoir slot, with the request's image and final
latent. The check (``check``) follows each kept request step by step with
the plain sampler from the program's own predictions, runs the plain UNet
on a sample of the recorded calls, and the plain decoder on the final
latent.
"""

from __future__ import annotations

import gc
import re
import sys

import numpy as np
import torch

from benchmark import rooflines, weights
from benchmark.reference import ops as ref_ops
from benchmark.reference.sampling import FusionReference, gaussian
from benchmark.reference.unet2d import UNet2D
from benchmark.reference.vae import VAE
from benchmark.systems.record import DTYPES, Recorder, follow, rel_l2, sync

CROSS_KV = re.compile(r"attn2\.to_[kv]\.weight$")
SLICE_CALLS = {"joint": 2, "fused": 4}  # the traced slice: UNet calls by phase, 24 : 51 per image
COMPARED = ("update_rel", "unet_rel", "decode_abs")  # what ``System.check`` returns


def program_configs(cfg: dict, wl: dict):
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig

    u, v, s = cfg["unet"], cfg["vae"], cfg["sampling"]
    ucfg = UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(u["down_block_types"]), up_block_types=tuple(u["up_block_types"]),
        layers_per_block=u["layers_per_block"],
        transformer_layers_per_block=tuple(u["transformer_layers_per_block"]),
        num_attention_heads=tuple(u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"], norm_num_groups=u["norm_num_groups"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        pooled_projection_dim=cfg["text"]["pooled_dim"], concept_slots=s["num_concepts"] + 1,
        quant=wl["quant"], dtype=DTYPES[u["dtype"]])
    vcfg = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                     latent_channels=v["latent_channels"],
                     block_out_channels=tuple(v["block_out_channels"]),
                     layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
                     scaling_factor=v["scaling_factor"], dtype=DTYPES[v["dtype"]])
    fcfg = FusionConfig(n_timesteps=s["n_timesteps"], guidance_scale=s["guidance_scale"],
                        t_cond=s["t_cond"], resampling_steps=s["resampling_steps"],
                        jumping_steps=s["jumping_steps"], jump_stride=s["jump_stride"],
                        height=s["height"], width=s["width"], num_concepts=s["num_concepts"])
    return ucfg, vcfg, fcfg


class System:
    unit = "image"

    @classmethod
    def compares(cls, wl: dict) -> tuple:
        """The names of the numbers ``check`` returns for workload ``wl``
        (``missed_kernel_path`` is the harness's): a cell's ``limits`` name
        exactly these."""
        return COMPARED

    def __init__(self, cfg: dict, wl: dict, seed: int, device: str):
        from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
        from tweediemix_tpu_torch.fusion.sampler import TextEmbeds
        from tweediemix_tpu_torch.models.convert import load_unet, load_vae
        from tweediemix_tpu_torch.ops.quant import load_static_scales

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        s = cfg["sampling"]
        self.n, self.S = s["num_concepts"], wl["seeds_per_request"]
        self.hw = (s["height"] // 8, s["width"] // 8)
        self.plain = FusionReference(s)
        ucfg, vcfg, fcfg = program_configs(cfg, wl)
        self.embeds = self.draw_embeds()
        self.fg = self.masks()
        unet_w, kvs, vae_w = self.draw_weights()
        self.amax = None
        if wl["quant"]:
            self.amax = self.calibrate(unet_w, kvs)
        unet = load_unet(unet_w, ucfg, self.device, concept_kvs=kvs)
        vae = load_vae(vae_w, vcfg, self.device)
        del unet_w, kvs, vae_w
        self.pipe = TweedieMixPipeline(unet, vae, fcfg, device=self.device)
        if self.amax is not None:
            found = load_static_scales(self.pipe.unet, self.amax)
            if found != len(self.amax):
                raise RuntimeError(f"the program took {found} of {len(self.amax)} static scales")
        self.embed_tuple = TextEmbeds(**self.embeds)
        calls = len(self.plain.calls())
        up = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)  # the decoder's upscale
        h, w = self.hw
        self.recorder = Recorder(
            wl["check"]["requests"] + 1, calls, (self.S, h, w, 4), ((self.n + 1) * self.S, h, w, 4),
            (self.S, h * up, w * up, 3), (self.S, h, w, 4), self.device,
            take_x=lambda x: x[:self.S], key=lambda x, t, args, eps: (int(t), int(eps.shape[0])))
        self.pipe.sampler.unet_fn = self.recorder.wrap(self.pipe.sampler.unet_fn)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- inputs ------------------------------------------------------------------

    def draw_embeds(self) -> dict:
        """Text embeddings per phase row layout: joint [uncond, multi],
        single [concepts but the background], concept [uncond, concepts]."""
        t, n, dev = self.cfg["text"], self.n, self.device
        ctx = weights.normal((n + 2, t["tokens"], t["dim"]), t["scale"], self.seed, 1, dev)
        pooled = weights.normal((n + 2, t["pooled_dim"]), t["scale"], self.seed, 2, dev)
        # rows: 0 uncond, 1 multi, 2.. the N concepts' prompts
        return dict(joint_ctx=ctx[:2].contiguous(), joint_pooled=pooled[:2].contiguous(),
                    single_ctx=ctx[2:n + 1].contiguous(), single_pooled=pooled[2:n + 1].contiguous(),
                    concept_ctx=torch.cat([ctx[:1], ctx[2:]]), concept_pooled=torch.cat([pooled[:1], pooled[2:]]))

    def masks(self) -> torch.Tensor:
        """Equal vertical stripes, one per foreground concept: halves for
        two."""
        s = self.cfg["sampling"]
        h, w, k = s["height"], s["width"], self.n - 1
        fg = torch.zeros((k, h, w), device=self.device)
        for c in range(k):
            fg[c, :, c * w // k:(c + 1) * w // k] = 1.0
        return fg

    def reference_models(self):
        with torch.device("meta"):
            unet, vae = UNet2D(self.cfg["unet"]), VAE(self.cfg["vae"])
        return unet, vae

    def draw_weights(self):
        unet, vae = self.reference_models()
        shapes = weights.shapes_of(unet)
        dt = DTYPES[self.cfg["unet"]["dtype"]]
        unet_w = weights.draw(shapes, dt, self.seed, 100, self.device)
        kv_shapes = {k: v for k, v in shapes.items() if CROSS_KV.search(k)}
        kvs = [weights.draw(kv_shapes, dt, self.seed, 100 + c, self.device)
               for c in range(1, self.n + 1)]
        vae_w = weights.draw(weights.shapes_of(vae), DTYPES[self.cfg["vae"]["dtype"]], self.seed,
                             200, self.device)
        return unet_w, kvs, vae_w

    def build_reference(self, unet_w, kvs, vae_w=None):
        unet, vae = self.reference_models()
        unet.load_state_dict(unet_w, assign=True)
        unet.set_concepts(kvs)
        sites = unet.mark_sites()
        if self.amax is not None and sites != len(self.amax):
            raise RuntimeError(f"{sites} quantised sites in the reference, {len(self.amax)} scales")
        if vae_w is not None:
            vae.load_state_dict(vae_w, assign=True)
        return unet, vae

    def rows(self, phase: str):
        """(ctx, pooled, concept index) rows of a UNet call of ``phase``."""
        e, S, dev = self.embeds, self.S, self.device
        if phase == "prologue":
            ctx = torch.cat([e["joint_ctx"], e["single_ctx"]])
            pooled = torch.cat([e["joint_pooled"], e["single_pooled"]])
            idx = torch.zeros(ctx.shape[0], dtype=torch.long, device=dev)
        elif phase == "joint":
            ctx, pooled = e["joint_ctx"], e["joint_pooled"]
            idx = torch.zeros(2, dtype=torch.long, device=dev)
        else:
            ctx, pooled = e["concept_ctx"], e["concept_pooled"]
            idx = torch.arange(self.n + 1, device=dev)
        return (ctx.repeat_interleave(S, 0), pooled.repeat_interleave(S, 0),
                idx.repeat_interleave(S, 0))

    def time_ids(self, b: int) -> torch.Tensor:
        s = self.cfg["sampling"]
        return torch.tensor([[s["height"], s["width"], 0, 0, s["height"], s["width"]]],
                            dtype=torch.float32, device=self.device).expand(b, 6)

    def ref_eps(self, unet, x, t, phase):
        ctx, pooled, idx = self.rows(phase)
        k = ctx.shape[0] // self.S
        xin = x.repeat(k, 1, 1, 1)
        return unet(xin, t, ctx, pooled, self.time_ids(xin.shape[0]), idx)

    @torch.no_grad()
    def calibrate(self, unet_w, kvs) -> dict:
        """{site: margin * the largest |x| at the site} over one plain fp32
        fused call per calibration timestep, on a standard-normal latent
        drawn from the seed."""
        unet, _ = self.build_reference(unet_w, kvs)
        cal = self.wl["calibration"]
        amax = {}

        def hook(m, inputs):
            seen = float(inputs[0].abs().max())
            amax[m.site] = max(amax.get(m.site, 0.0), seen)

        hooks = [m.register_forward_pre_hook(hook) for m in unet.modules()
                 if isinstance(m, ref_ops.Linear) and m.site is not None]
        x = weights.normal((self.S, *self.hw, 4), 1.0, self.seed, 3, self.device)
        try:
            for t in cal["timesteps"]:
                self.ref_eps(unet, x, t, "fused")
        finally:
            for h in hooks:
                h.remove()
        return {k: cal["margin"] * v for k, v in amax.items()}

    # -- the program ---------------------------------------------------------------

    @torch.inference_mode()
    def warm(self):
        """One UNet call of each batch and each cross-attention cache, the
        sampler's update and the decode: every shape a request uses."""
        sp = self.pipe.sampler
        x = self.pipe.sampler.init_latent(0, self.S, self.device)
        masks = sp.compute_masks(x, self.fg)
        sp.joint_scan(self.embed_tuple, x, 1, 2)
        sp.fused_scan(self.embed_tuple, x, masks, sp.config.t_cond_idx, sp.config.t_cond_idx + 1)
        self.pipe.decode_final(x[:1])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def launch_counts(self) -> dict:
        from tweediemix_tpu_torch.ops.flash_attention import (
            flash_attention,
            flash_attention_int8,
            quantize_qkv_int8_fused,
        )

        return dict(flash_attention=flash_attention.launches,
                    flash_attention_int8=flash_attention_int8.launches,
                    quantize_qkv_int8_fused=quantize_qkv_int8_fused.launches)

    def call_rows(self):
        """{phase: rows} of the configuration's UNet calls."""
        return {"prologue": (self.n + 1) * self.S, "joint": 2 * self.S,
                "fused": (self.n + 1) * self.S}

    def flash_sites(self) -> int:
        """Flash launches per request, from the configuration's site
        arithmetic."""
        rows = self.call_rows()
        return sum(rooflines.launches(rooflines.fusion_flash_shapes(self.cfg["unet"], self.hw, rows[p]))
                   for p in self.plain.calls())

    def expected_launches(self) -> dict:
        sites = self.flash_sites()
        return {k: sites if v == "sites" else v for k, v in self.wl["kernels"].items()}

    def request(self, req_seed: int, slot: int) -> dict:
        self.recorder.begin(slot)
        img = self.pipe.sample(self.embed_tuple, seed=req_seed, fg_masks=self.fg,
                               num_seeds=self.S)
        self.recorder.end(img, self.pipe.last_latent)
        return dict(phases=dict(self.pipe.phase_seconds))

    def traced_slice(self):
        """(the slice's work, what it holds): SLICE_CALLS UNet calls of the
        joint and fused phases through the program's own sampler, each call
        under a ``unet_call.b<rows>`` range."""
        sp = self.pipe.sampler
        c = sp.config
        x = sp.init_latent(1, self.S, self.device)
        masks = sp.compute_masks(x, self.fg)
        calls = dict(joint=min(SLICE_CALLS["joint"], c.t_cond_idx - 1),
                     fused=min(SLICE_CALLS["fused"], c.n_timesteps - c.t_cond_idx))

        @torch.inference_mode()
        def work():
            self.recorder.label = True
            try:
                sp.joint_scan(self.embed_tuple, x, 1, 1 + calls["joint"])
                sp.fused_scan(self.embed_tuple, x, masks, c.t_cond_idx, c.t_cond_idx + calls["fused"])
                sync(self.device)
            finally:
                self.recorder.label = False

        rows = self.call_rows()
        shapes = {}
        for phase, k in calls.items():
            for shape, n in rooflines.fusion_flash_shapes(self.cfg["unet"], self.hw, rows[phase]).items():
                shapes[shape] = shapes.get(shape, 0) + n * k
        return work, dict(unet_calls=sum(calls.values()), flash_shapes=shapes)

    def work(self) -> dict:
        """Operations of one request by tag (``reference.ops.WorkCounter``;
        the decode's under ``vae_``), counted on the meta device: the
        cross-attention K/V once per phase's rows."""
        unet, vae = self.reference_models()
        if self.wl["quant"]:
            unet.mark_sites()
            ref_ops.set_precision(unet, ref_ops.Precision(
                amax={}, int8_attention=self.wl["env"].get("TWEEDIEMIX_FLASH_INT8") == "1"))
        h, w = self.hw
        rows = self.call_rows()
        per_rows = {}
        t = self.cfg["text"]
        for b in sorted(set(rows.values())):
            with ref_ops.counting() as cnt, torch.no_grad():
                dev = torch.device("meta")
                unet(torch.empty((b, h, w, 4), device=dev), 1,
                     torch.empty((b, t["tokens"], t["dim"]), device=dev),
                     torch.empty((b, t["pooled_dim"]), device=dev),
                     torch.empty((b, 6), device=dev), torch.zeros(b, dtype=torch.long, device=dev))
            per_rows[b] = cnt.ops
        total: dict = {}
        kv_rows = 0
        for phase in self.plain.calls():
            for tag, n in per_rows[rows[phase]].items():
                if tag != "invariant":
                    total[tag] = total.get(tag, 0.0) + n
        # each phase's cache: prologue (its rows and the joint rows), joint, jumping, fused
        kv_rows = rows["prologue"] + 3 * rows["joint"] + rows["fused"]
        b = max(per_rows)
        total["invariant"] = per_rows[b].get("invariant", 0.0) * kv_rows / b
        with ref_ops.counting() as cnt, torch.no_grad():
            vae.decode_image(torch.empty((self.S, h, w, 4), device="meta"))
        for tag, n in cnt.ops.items():
            total["vae_" + tag] = n
        return total

    # -- the check ------------------------------------------------------------------

    def reference_precision(self, bits: int = 8):
        """The plain UNet's precision: fp32, or the W8A8 configuration's
        (``bits``: 8, or 4 for its control) with the scales set up."""
        if not self.wl["quant"]:
            return ref_ops.FP32
        return ref_ops.Precision(amax=self.amax, bits=bits,
                                 int8_attention=self.wl["env"].get("TWEEDIEMIX_FLASH_INT8") == "1")

    @torch.no_grad()
    def check(self, reservoir, control: dict | None = None):
        """(the compared numbers over the kept requests, the control's or
        None; module docstring): ``update_rel`` (the sampler followed step by
        step, every call's latent input and the final latent, relative to
        the plain run's largest value), ``unet_rel`` (the plain UNet on
        sampled calls, relative L2 of the noise prediction), ``decode_abs``
        (the plain decode of the final latent against the image, in [0, 1]).

        With ``control`` each number also of the control, one precision below
        the configuration's, in the program's place: the update in bfloat16,
        the decode with TF32, and the UNet either the program as built (its
        own lower-precision path) or, with ``control["bits"]``, the plain UNet
        at that many bits."""
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        unet_w, kvs, vae_w = self.draw_weights()
        unet, vae = self.build_reference(unet_w, kvs, vae_w)
        rec, plain = self.recorder, self.plain
        precision = self.reference_precision()
        ref_ops.set_precision(unet, precision)
        masks = plain.region_masks(self.fg)
        phases = plain.calls()
        rng = np.random.default_rng([abs(self.seed), 0xC4EC])
        out = dict.fromkeys(COMPARED, 0.0)
        ctl = dict(out) if control else None
        bits = (control or {}).get("bits")
        for kept in reservoir.kept:
            slot, meta = kept["slot"], rec.meta[kept["slot"]]
            x0 = torch.stack([gaussian(kept["seed"], s, (*self.hw, 4), self.device)
                              for s in range(self.S)])
            program, lower = follow(rec, slot, lambda dtype, predict: self.plain_run(
                x0, masks, dtype, predict), bool(control))
            out["update_rel"] = max(out["update_rel"], program)
            for phase, count in self.wl["check"]["unet_calls"].items():
                cand = [j for j, p in enumerate(phases) if p == phase]
                for j in rng.choice(cand, size=count, replace=False):
                    if j >= len(meta) or j >= rec.calls:
                        out["unet_rel"] = float("inf")
                        if control:
                            ctl["unet_rel"] = float("inf")
                        continue
                    want = self.ref_eps(unet, rec.x[slot, j], meta[j][0], phases[j])
                    got = rec.eps[slot, j, :meta[j][1]]
                    r = rel_l2(got, want) if got.shape == want.shape else float("inf")
                    out["unet_rel"] = max(out["unet_rel"], r)
                    line = (f"check: request {kept['index']} call {j} ({phase}, t {meta[j][0]}): "
                            f"unet_rel {r!r}")
                    if bits:  # the plain UNet at fewer bits in the program's place
                        ref_ops.set_precision(unet, self.reference_precision(bits))
                        r = rel_l2(self.ref_eps(unet, rec.x[slot, j], meta[j][0], phases[j]), want)
                        ref_ops.set_precision(unet, precision)
                        line += f", control {r!r}"
                    if control:
                        ctl["unet_rel"] = max(ctl["unet_rel"], r)
                    print(line, file=sys.stderr)
            lat = rec.latents[slot]
            want = torch.cat([vae.decode_image(lat[i:i + 1]) for i in range(self.S)])
            got = rec.outputs[slot].float()
            out["decode_abs"] = max(out["decode_abs"], float((got - want).abs().max()))
            if control:
                ctl["update_rel"] = max(ctl["update_rel"], lower)
                with ref_ops.tf32(True):
                    got = torch.cat([vae.decode_image(lat[i:i + 1]) for i in range(self.S)])
                ctl["decode_abs"] = max(ctl["decode_abs"], float((got - want).abs().max()))
        return out, ctl

    def plain_run(self, x0, masks, dtype, predict):
        """The plain sampler in ``dtype`` from ``x0``, each call's prediction
        asked of ``predict(x, (t, rows), rows)``."""
        rows = self.call_rows()
        return FusionReference(self.cfg["sampling"], dtype).run(
            x0, masks, lambda xr, t, phase: predict(xr, (int(t), rows[phase]), rows[phase]))
