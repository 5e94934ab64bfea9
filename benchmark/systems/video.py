"""Driver of the video configuration: I2VGen-XL image-to-video through
``tweediemix_tpu_torch`` (``I2VPipeline.generate``, which encodes the first
frame, runs the 50-step loop and decodes every frame in fp32).

As in ``systems/fusion.py``: the weights, the conditioning picture, the
text contexts and the image embedding are drawn from the seed and handed
to the program's loaders; each request's UNet calls (latent input, noise
prediction, injection flag) are recorded into a reservoir slot with its
frames and final latent; the check follows the loop step by step from the
program's predictions, runs the plain UNet (with the plain VAE's encode of
the first frame) on sampled calls, and the plain decoder on sampled frames.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import sys

import numpy as np
import torch

from benchmark import rooflines, weights
from benchmark.reference import ops as ref_ops
from benchmark.reference.sampling import VideoReference, gaussian
from benchmark.reference.unet3d import UNet3D
from benchmark.reference.vae import VAE
from benchmark.systems.record import DTYPES, Recorder, follow, rel_l2, sync

SLICE_STEPS = 6  # the traced slice: loop steps, after the injection
COMPARED = ("update_rel", "unet_rel", "site_rel", "decode_abs")  # what ``System.check`` returns


def program_configs(cfg: dict, wl: dict):
    from tweediemix_tpu_torch.models.unet3d import UNet3DConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.video.pipeline import VideoConfig

    u, v, s = cfg["unet"], cfg["vae"], cfg["sampling"]
    ucfg = UNet3DConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(u["down_block_types"]), layers_per_block=u["layers_per_block"],
        attention_head_dim=u["attention_head_dim"], cross_attention_dim=u["cross_attention_dim"],
        norm_num_groups=u["norm_num_groups"], context_pool_size=u["context_pool_size"],
        quant=wl["quant"], dtype=DTYPES[u["dtype"]])
    vcfg = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                     latent_channels=v["latent_channels"],
                     block_out_channels=tuple(v["block_out_channels"]),
                     layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
                     scaling_factor=v["scaling_factor"], dtype=DTYPES[v["dtype"]])
    vid = VideoConfig(n_timesteps=s["n_timesteps"], guidance_scale=s["guidance_scale"],
                      num_frames=s["num_frames"], height=s["height"], width=s["width"],
                      fps=s["fps"], injection_timestep=s["injection_timestep"],
                      interp_ratio=s["interp_ratio"], num_train_timesteps=s["num_train_timesteps"],
                      beta_start=s["beta_start"], beta_end=s["beta_end"],
                      steps_offset=s["steps_offset"], latent_factor=latent_factor(cfg))
    return ucfg, vcfg, vid


def latent_factor(cfg: dict) -> int:
    """The VAE's spatial downscale: 2 per down block after the first."""
    return 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


class System:
    unit = "clip"

    @classmethod
    def compares(cls, wl: dict) -> tuple:
        """The names of the numbers ``check`` returns for workload ``wl``
        (``missed_kernel_path`` is the harness's): a cell's ``limits`` name
        exactly these."""
        return COMPARED

    def __init__(self, cfg: dict, wl: dict, seed: int, device: str):
        from tweediemix_tpu_torch.models.convert import load_unet3d, load_vae
        from tweediemix_tpu_torch.video.pipeline import I2VPipeline

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        s = cfg["sampling"]
        self.B, self.F = wl["clips_per_request"], s["num_frames"]
        self.hw = (s["height"] // latent_factor(cfg), s["width"] // latent_factor(cfg))
        self.plain = VideoReference(s)
        ucfg, vcfg, vid = program_configs(cfg, wl)
        self.inputs = self.draw_inputs()
        unet_w, vae_w = self.draw_weights()
        unet = load_unet3d(unet_w, ucfg, self.device)
        vae = load_vae(vae_w, vcfg, self.device)
        del unet_w, vae_w
        self.pipe = I2VPipeline(vid, unet, vae, device=self.device)
        self.recorder = Recorder(
            wl["check"]["requests"] + 1, s["n_timesteps"], (self.B, self.F, *self.hw, 4),
            (2 * self.B, self.F, *self.hw, 4), (self.B, self.F, s["height"], s["width"], 3),
            (self.B, self.F, *self.hw, 4), self.device, take_x=lambda x: x[::2],
            key=lambda x, t, args, eps: (int(t), bool(args[4]) if len(args) > 4 else False))
        self.pipe.unet.forward = self.recorder.wrap(self.pipe.unet.forward)
        site = wl["check"]["site"]
        self.recorder.watch(self.pipe.unet.get_submodule(site["module"]), site["rows"])
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def draw_inputs(self) -> dict:
        t, s, dev = self.cfg["text"], self.cfg["sampling"], self.device
        return dict(
            text=weights.normal((1, t["tokens"], t["dim"]), t["scale"], self.seed, 1, dev),
            uncond=weights.normal((1, t["tokens"], t["dim"]), t["scale"], self.seed, 2, dev),
            image=weights.uniform((self.B, s["height"], s["width"], 3), -1.0, 1.0, self.seed, 3, dev),
            emb=weights.normal((1, 1, t["dim"]), t["scale"], self.seed, 4, dev))

    def reference_models(self):
        with torch.device("meta"):
            return UNet3D(self.cfg["unet"]), VAE(self.cfg["vae"])

    def draw_weights(self):
        unet, vae = self.reference_models()
        unet_w = weights.draw(weights.shapes_of(unet), DTYPES[self.cfg["unet"]["dtype"]],
                              self.seed, 100, self.device)
        vae_w = weights.draw(weights.shapes_of(vae), DTYPES[self.cfg["vae"]["dtype"]], self.seed,
                             200, self.device)
        return unet_w, vae_w

    # -- the program ---------------------------------------------------------------

    def conditioning(self, noise):
        """The loop's rows as the program builds them in ``generate``:
        (ctx2, image latents2, image embedding2, fps2), clips interleaved
        (uncond, cond)."""
        p, i, b = self.pipe, self.inputs, self.B

        def inter(u, c):
            return torch.stack([u, c], dim=1).reshape(2 * b, *u.shape[1:])

        frame0 = p.encode_first_frame(i["image"], noise)
        lat = p.prepare_image_latents(frame0)
        emb = i["emb"].expand(b, *i["emb"].shape[1:])
        return (inter(i["uncond"].expand(b, -1, -1), i["text"].expand(b, -1, -1)), inter(lat, lat),
                inter(torch.zeros_like(emb), emb),
                torch.full((2 * b,), float(self.cfg["sampling"]["fps"]), device=self.device))

    def warm(self):
        """The loop's UNet call with and without injection, the first-frame
        encode, the step-invariant cache and the decode of one frame."""
        from tweediemix_tpu_torch.models.unet3d import precompute_video_cache

        p = self.pipe
        with torch.inference_mode():
            noise = torch.zeros((self.B, *self.hw, 4), device=self.device)
            rows = self.conditioning(noise)
            cache = precompute_video_cache(p.unet, *rows)
            x = torch.zeros((self.B, self.F, *self.hw, 4), device=self.device)
            part = copy.copy(p)
            part.table = copy.copy(p.table)
            part.table.timesteps = p.table.timesteps[:2]
            part.loop(x, *rows, cache)
            p.decode_video(x[:, :1])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def launch_counts(self) -> dict:
        from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8
        from tweediemix_tpu_torch.ops.short_attention import short_seq_attention

        return dict(short_seq_attention=short_seq_attention.launches,
                    flash_attention=flash_attention.launches,
                    flash_attention_int8=flash_attention_int8.launches)

    def kernel_shapes(self):
        return rooflines.video_kernel_shapes(self.cfg["unet"], self.hw, 2 * self.B, self.F)

    def expected_launches(self) -> dict:
        flash, short = self.kernel_shapes()
        steps = self.cfg["sampling"]["n_timesteps"]
        sites = dict(flash_attention=rooflines.launches(flash) * steps,
                     short_seq_attention=rooflines.launches(short) * steps)
        return {k: sites[k] if v == "sites" else v for k, v in self.wl["kernels"].items()}

    def request(self, req_seed: int, slot: int) -> dict:
        i = self.inputs
        self.recorder.begin(slot)
        video = self.pipe.generate(i["text"], i["uncond"], i["image"], i["emb"], seed=req_seed)
        self.recorder.end(video.reshape(self.B, self.F, *video.shape[-3:]), self.pipe.last_latent)
        return dict(phases=dict(self.pipe.phase_seconds))

    def traced_slice(self):
        """(the slice's work, what it holds): SLICE_STEPS steps of the
        program's loop, after the injection, each call under a
        ``unet_call.b<rows>`` range."""
        from tweediemix_tpu_torch.models.unet3d import precompute_video_cache

        p = self.pipe
        with torch.inference_mode():
            rows = self.conditioning(gaussian(self.seed, 1, (self.B, *self.hw, 4), self.device))
            cache = precompute_video_cache(p.unet, *rows)
        x = torch.stack([gaussian(self.seed, 2 * b, (self.F, *self.hw, 4), self.device)
                         for b in range(self.B)])
        part = copy.copy(p)
        part.config = dataclasses.replace(p.config, injection_timestep=0.0)
        part.table = copy.copy(p.table)
        first = max(0, min(10, len(p.table.timesteps) - SLICE_STEPS))
        part.table.timesteps = p.table.timesteps[first:first + SLICE_STEPS]
        steps = len(part.table.timesteps)

        @torch.inference_mode()
        def work():
            self.recorder.label = True
            try:
                part.loop(x, *rows, cache)
                sync(self.device)
            finally:
                self.recorder.label = False

        flash, short = self.kernel_shapes()
        return work, dict(unet_calls=steps, flash_shapes={k: v * steps for k, v in flash.items()},
                          short_shapes={k: v * steps for k, v in short.items()})

    def work(self) -> dict:
        """Operations of one request by tag, counted on the meta device: the
        loop's calls, the step-invariant work once, the first frame's
        encode and every frame's decode under ``vae_``."""
        unet, vae = self.reference_models()
        h, w = self.hw
        t, d = self.cfg["text"], self.cfg["unet"]["cross_attention_dim"]
        b, dev = 2 * self.B, torch.device("meta")
        with ref_ops.counting() as cnt, torch.no_grad():
            unet(torch.empty((b, self.F, h, w, 4), device=dev), 1,
                 torch.empty((b, t["tokens"], d), device=dev),
                 torch.empty((b, self.F, h, w, 4), device=dev), torch.empty((b, 1, d), device=dev),
                 torch.empty((b,), device=dev), False, 0.7)
        steps = self.cfg["sampling"]["n_timesteps"]
        total = {k: v * (1 if k == "invariant" else steps) for k, v in cnt.ops.items()}
        s = self.cfg["sampling"]
        with ref_ops.counting() as cnt, torch.no_grad():
            vae.encode_sample(torch.empty((self.B, s["height"], s["width"], 3), device=dev),
                              torch.empty((self.B, h, w, 4), device=dev))
            vae.decode_image(torch.empty((self.B * self.F, h, w, 4), device=dev))
        for tag, n in cnt.ops.items():
            total["vae_" + tag] = n
        return total

    # -- the check ------------------------------------------------------------------

    @torch.no_grad()
    def check(self, reservoir, control: dict | None = None):
        """As ``systems/fusion.py``'s: ``update_rel`` (the loop followed step
        by step), ``unet_rel`` (the plain UNet on sampled calls, one with
        the injection and one without, its conditioning worked out by the
        plain VAE), ``site_rel`` (the workload's ``check.site`` layer of the
        plain UNet on the rows of its input that the program recorded at
        those calls, relative L2 of its output), ``decode_abs`` (sampled
        frames decoded by the plain VAE). With ``control`` each number also of the control: the loop in
        bfloat16 against fp32, the program as built (its own
        lower-precision path) against the plain UNet, and the decode with
        TF32 against fp32."""
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        unet_w, vae_w = self.draw_weights()
        unet, vae = self.reference_models()
        unet.load_state_dict(unet_w, assign=True)
        vae.load_state_dict(vae_w, assign=True)
        rec, plain, s = self.recorder, self.plain, self.cfg["sampling"]
        rng = np.random.default_rng([abs(self.seed), 0xC4EC])
        out = dict.fromkeys(COMPARED, 0.0)
        ctl = dict(out) if control else None
        site = unet.get_submodule(self.wl["check"]["site"]["module"])
        n_inject = plain.injection_steps()
        for kept in reservoir.kept:
            slot, rseed, meta = kept["slot"], kept["seed"], rec.meta[kept["slot"]]
            x0 = torch.stack([gaussian(rseed, 2 * b, (self.F, *self.hw, 4), self.device)
                              for b in range(self.B)])
            program, lower = follow(rec, slot, lambda dtype, predict: VideoReference(s, dtype).run(
                x0, lambda xr, t, inject: predict(xr, (int(t), bool(inject)), 2 * xr.shape[0])),
                bool(control))
            out["update_rel"] = max(out["update_rel"], program)
            noise = torch.stack([gaussian(rseed, 2 * b + 1, (*self.hw, 4), self.device)
                                 for b in range(self.B)])
            frame0 = vae.encode_sample(self.inputs["image"], noise)
            il2 = plain.image_latents(frame0).repeat_interleave(2, dim=0)
            emb = self.inputs["emb"].expand(self.B, -1, -1)
            emb2 = torch.stack([torch.zeros_like(emb), emb], dim=1).reshape(2 * self.B, 1, -1)
            ctx2 = torch.stack([self.inputs["uncond"].expand(self.B, -1, -1),
                                self.inputs["text"].expand(self.B, -1, -1)], dim=1)
            ctx2 = ctx2.reshape(2 * self.B, *ctx2.shape[2:])
            fps2 = torch.full((2 * self.B,), float(s["fps"]), device=self.device)
            picks = []
            for kind, count in self.wl["check"]["unet_calls"].items():
                cand = list(range(n_inject)) if kind == "inject" else list(
                    range(n_inject, s["n_timesteps"]))
                picks += [int(j) for j in rng.choice(cand, size=min(count, len(cand)), replace=False)]
            for j in picks:
                if j >= len(meta) or j >= rec.calls:
                    r = r_site = float("inf")
                else:
                    t, inject = meta[j]
                    want = unet(rec.x[slot, j].repeat_interleave(2, dim=0), t, ctx2, il2, emb2,
                                fps2, inject, s["interp_ratio"])
                    r = rel_l2(rec.eps[slot, j], want)
                    r_site = rel_l2(rec.site_y[slot, j], site(rec.site_x[slot, j]))
                    print(f"check: request {kept['index']} call {j} (t {t}, injection {inject}): "
                          f"unet_rel {r!r} site_rel {r_site!r}", file=sys.stderr)
                out["unet_rel"] = max(out["unet_rel"], r)
                out["site_rel"] = max(out["site_rel"], r_site)
            frames = rng.choice(self.F, size=min(self.wl["check"]["frames"], self.F), replace=False)
            for f in sorted(int(f) for f in frames):
                lat = rec.latents[slot][:, f]
                want = vae.decode_image(lat)
                got = rec.outputs[slot][:, f].float()
                out["decode_abs"] = max(out["decode_abs"], float((got - want).abs().max()))
                if control:
                    with ref_ops.tf32(True):
                        got = vae.decode_image(lat)
                    ctl["decode_abs"] = max(ctl["decode_abs"], float((got - want).abs().max()))
            if control:
                ctl["update_rel"] = max(ctl["update_rel"], lower)
        if control:  # the program as built is the control's UNet
            ctl["unet_rel"], ctl["site_rel"] = out["unet_rel"], out["site_rel"]
        return out, ctl
