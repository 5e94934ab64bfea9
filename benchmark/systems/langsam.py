"""The system of the in-loop segmentation configuration: TweedieMix fusion on
SDXL with the region masks from the program's own LangSAM (OWL-ViT
base-patch32 boxes, SAM ViT-H masks) on the decoded Tweedie preview at
t_cond, through ``tweediemix_tpu_torch`` (``TweedieMixPipeline.sample`` with
``fg_masks=None`` and the sampler's ``segment_fn`` from
``segmentation.make_model_segment_fn``, as the fusion CLI builds it).

A workload's ``mode`` is its request: ``loop``, one image as the fusion
cells make it but with in-loop segmentation, timed as ``s_per_image``;
``segment``, one ``segment_fn`` call on a 1024x1024 image drawn from the
request's seed (a uniform field of ``image.field``² cells upsampled
bilinearly, plus N(0, ``image.noise``²) per pixel, clipped to [0, 1]), with
no pipeline and no SDXL weights, timed as ``s_per_call``.

Set-up draws SAM and OWL-ViT from their own streams under their published
names and hands them to the program's loaders (``models/convert.py``:
``load_sam``, ``load_detector``); ``loop`` draws SDXL as ``fusion`` does.

Each kept request records (``SegRecorder``) the image ``segment_fn`` was
given (the preview image in ``loop``), each phrase's boxes, scores and
mask logits (``LangSAM.predict_logits``), the masks it returned, and in
``loop`` the preview latent, beside what ``fusion`` records. The check
follows the program from its own state:

* ``box_abs``: the plain OWL-ViT on the image each phrase saw, against the
  program's boxes and scores (``box_gap``);
* ``seg_rel``: the plain SAM on that image and the program's own boxes,
  relative L2 of the mask logits, the largest over the phrases; and the
  plain contract (best box, black-out, rectangle, overlap) on the
  program's logits against the masks it returned, relative L2;
* ``preview_abs`` (``loop``): the plain decode of the recorded preview
  latent against the program's preview image;
* ``update_rel``, ``unet_rel``, ``decode_abs`` (``loop``): ``fusion``'s,
  with the plain sampler fed the program's recorded region masks;
  ``update_rel`` also holds the preview latent against the plain Tweedie
  of the last jumping call.

The control (``controls.py``, the workload's ``control``) puts the plain
SAM image encoder and detector with TF32 on (``control["tf32"]``) in the
program's place, and the preview decode with TF32, beside ``fusion``'s.
"""

from __future__ import annotations

import gc
import sys
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import ops as ref_ops
from benchmark.reference import owlvit as ref_owlvit
from benchmark.reference import sam as ref_sam
from benchmark.reference.sampling import cfg_mix
from benchmark.reference.vae import VAE
from benchmark.seg_models import draw_seg_weights, program_detector_config, program_sam_config, seg_reference
from benchmark.systems import fusion
from benchmark.systems.record import DTYPES, rel_l2, rel_max, sync

FIELD_STREAM, NOISE_STREAM = 10, 11
SEGMENTATION = ("box_abs", "seg_rel")  # compared in both modes
PREVIEW = ("preview_abs",)  # compared in ``loop``, with ``fusion.COMPARED``


def box_gap(boxes, scores, ref_boxes, ref_scores) -> float:
    """The largest gap of the program's top boxes from the plain detector's
    boxes of every patch: its scores against the plain run's highest as
    many, and each (box, score) against the nearest (box, score) of a patch
    (max abs over the five numbers). Matched by nearness, not by rank:
    scores within rounding of each other may swap places."""
    k = scores.shape[0]
    if boxes.shape != (k, 4) or k > ref_scores.shape[0]:
        return float("inf")
    _, want = ref_owlvit.top(ref_boxes, ref_scores, k)
    gap = (scores.float() - want).abs().max()
    got = torch.cat([boxes.float(), scores.float()[:, None]], dim=1)
    ref = torch.cat([ref_boxes, ref_scores[:, None]], dim=1)
    near = (got[:, None] - ref[None]).abs().amax(dim=-1).amin(dim=-1)
    return float(torch.maximum(gap, near.max()))


class SegRecorder:
    """Per reservoir slot: the image ``segment_fn`` was given, each
    phrase's boxes, scores and mask logits, the masks it returned, and the
    preview latent (``latent_shape``, ``loop``). Allocated once; ``bytes``
    as ``record.Recorder`` counts them."""

    def __init__(self, slots: int, phrases: int, boxes: int, hw, latent_shape, device):
        self.device, self.bytes = device, 0
        h, w = hw
        self.image = self.alloc((slots, h, w, 3))
        self.boxes = self.alloc((slots, phrases, boxes, 4))
        self.scores = self.alloc((slots, phrases, boxes))
        self.logits = self.alloc((slots, phrases, boxes, h, w))
        self.masks = self.alloc((slots, phrases, h, w))
        self.latent = self.alloc((slots, *latent_shape)) if latent_shape else None
        self.count = [0] * slots  # phrases recorded per slot; -1: a shape did not fit
        self.slot, self.on = 0, False

    def alloc(self, shape) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        out = torch.empty(shape, dtype=torch.float32, device=self.device)
        self.bytes += (torch.cuda.memory_allocated(self.device) - before if cuda
                       else out.numel() * out.element_size())
        return out

    def begin(self, slot: int) -> None:
        self.slot, self.on = slot, True
        self.count[slot] = 0

    def put(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if tuple(dst.shape) != tuple(src.shape):
            self.count[self.slot] = -1
        else:
            dst.copy_(src)

    def phrase(self, logits, boxes, scores) -> None:
        s, p = self.slot, self.count[self.slot]
        if not self.on or p < 0:
            return
        if p >= self.boxes.shape[1]:
            self.count[s] = -1
            return
        self.put(self.logits[s, p], logits)
        self.put(self.boxes[s, p], boxes)
        self.put(self.scores[s, p], scores)
        if self.count[s] >= 0:
            self.count[s] += 1

    def wrap_predict(self, predict_logits):
        def wrapped(image, text):
            logits, boxes, scores = predict_logits(image, text)
            self.phrase(logits, boxes, scores)
            return logits, boxes, scores
        return wrapped

    def wrap_segment(self, segment_fn):
        def wrapped(image):
            if self.on:
                self.put(self.image[self.slot], image[0] if image.ndim == 4 else image)
            out = segment_fn(image)
            if self.on:
                self.put(self.masks[self.slot], out)
            return out
        return wrapped

    def wrap_preview(self, decode_preview):
        def wrapped(x0):
            if self.on:
                self.put(self.latent[self.slot], x0)
            return decode_preview(x0)
        return wrapped


def preview_decode(vae: VAE, latent: torch.Tensor, factor: float) -> torch.Tensor:
    """The plain preview: the latent over ``factor`` decoded, mapped from
    [-1, 1] to [0, 1] and clamped."""
    z = latent.float() / factor
    img = vae.decoder(vae.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


class System(fusion.System):
    @classmethod
    def compares(cls, wl: dict) -> tuple:
        """The names of the numbers ``check`` returns for workload ``wl``
        (``missed_kernel_path`` is the harness's): a cell's ``limits`` name
        exactly these."""
        return fusion.COMPARED + PREVIEW + SEGMENTATION if wl["mode"] == "loop" else SEGMENTATION

    def __init__(self, cfg: dict, wl: dict, seed: int, device: str):
        from tweediemix_tpu_torch.models.convert import load_detector, load_sam
        from tweediemix_tpu_torch.segmentation import LangSAM, make_model_segment_fn
        from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

        self.loop = wl["mode"] == "loop"
        self.unit = "image" if self.loop else "call"  # what a request is: ``s_per_<unit>``
        if self.loop:
            if wl["seeds_per_request"] != 1:
                raise ValueError("in-loop segmentation records one seed's preview a request")
            super().__init__(cfg, wl, seed, device)
        else:
            self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        self.phrases = cfg["segmentation"]["phrases"].split("+")
        det = cfg["detector"]
        sam_w, det_w = draw_seg_weights(cfg, seed, self.device)
        det_cfg = program_detector_config(cfg)
        self.lang_sam = LangSAM(
            load_sam(sam_w, program_sam_config(cfg), self.device),
            load_detector(det_w, det_cfg, self.device),
            HashTokenizer(det_cfg.text.vocab_size, max_length=det_cfg.text.max_positions),
            box_threshold=det["box_threshold"])
        del sam_w, det_w
        self.segment_fn = make_model_segment_fn(self.lang_sam, cfg["segmentation"]["phrases"])
        s = cfg["sampling"]
        h, w = s["height"] // 8, s["width"] // 8
        up = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)  # the decoder's upscale
        self.image_hw = (h * up, w * up) if self.loop else (s["height"], s["width"])
        latent = (1, h, w, 4) if self.loop else None
        self.seg = SegRecorder(wl["check"]["requests"] + 1, len(self.phrases), det["max_boxes"],
                               self.image_hw, latent, self.device)
        self.lang_sam.predict_logits = self.seg.wrap_predict(self.lang_sam.predict_logits)
        self.segment = self.seg.wrap_segment(self.segment_fn)
        if self.loop:
            sp = self.pipe.sampler
            sp.segment_fn = self.segment
            sp.decode_preview_fn = self.seg.wrap_preview(sp.decode_preview_fn)
            self.recorder.bytes += self.seg.bytes
        else:
            self.recorder = self.seg
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def draw_image(self, req_seed: int) -> torch.Tensor:
        """The ``segment`` request's image [H, W, 3] in [0, 1] (module
        docstring)."""
        c, (h, w), dev = self.wl["image"], self.image_hw, self.device
        field = weights.uniform((1, 3, c["field"], c["field"]), 0.0, 1.0, req_seed, FIELD_STREAM, dev)
        img = F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)[0]
        img = img.permute(1, 2, 0) + weights.normal((h, w, 3), c["noise"], req_seed, NOISE_STREAM, dev)
        return img.clamp(0.0, 1.0)

    # -- the program -----------------------------------------------------------------

    @torch.inference_mode()
    def warm(self):
        """``fusion``'s warm-up and one in-loop segmentation (``loop``), or
        one ``segment_fn`` call."""
        if self.loop:
            super().warm()
            sp = self.pipe.sampler
            sp.compute_masks(sp.init_latent(0, 1, self.device), None)
        else:
            self.segment(self.draw_image(0))
        sync(self.device)

    def expected_launches(self) -> dict:
        return super().expected_launches() if self.loop else dict(self.wl["kernels"])

    def request(self, req_seed: int, slot: int) -> dict:
        self.seg.begin(slot)
        if self.loop:
            self.recorder.begin(slot)
            img = self.pipe.sample(self.embed_tuple, seed=req_seed, fg_masks=None, num_seeds=self.S)
            self.recorder.end(img, self.pipe.last_latent)
            phases = dict(self.pipe.phase_seconds)
        else:
            self.segment(self.draw_image(req_seed))
            phases = {}
        self.seg.on = False
        own = getattr(self.segment_fn, "own_seconds", None)  # a program without it: not read
        if own is not None:
            phases["segment"] = own
        return dict(phases=phases, fallbacks=len(self.segment_fn.no_detections))

    def traced_slice(self):
        """(the slice's work, what it holds): one boundary, the preview
        decode and ``segment_fn`` through the sampler's ``compute_masks``
        on the last request's preview latent (``loop``), or one
        ``segment_fn`` call (``segment``)."""
        if self.loop:
            sp = self.pipe.sampler
            x0 = self.seg.latent[self.seg.slot].clone()

            def call():
                sp.compute_masks(x0, None)
        else:
            image = self.draw_image(self.seed)

            def call():
                self.segment(image)

        @torch.inference_mode()
        def work():
            call()
            sync(self.device)

        return work, dict(segment_calls=1, seg_work=self.seg_work())

    def seg_work(self) -> dict:
        """Operations of one ``segment_fn`` call by tag, ``seg_`` before each
        (``reference.ops.WorkCounter``, on ``meta``): per phrase, the
        detector, SAM's encoder and the decoder over the top boxes."""
        sam, det = seg_reference(self.cfg)
        v, t = self.cfg["detector"]["vision_config"], self.cfg["detector"]["text_config"]
        size, dev = self.cfg["sam"]["image_size"], torch.device("meta")
        with ref_ops.counting() as cnt, torch.no_grad():
            for _ in self.phrases:
                det(torch.empty((1, v["image_size"], v["image_size"], 3), device=dev),
                    torch.zeros((1, t["max_position_embeddings"]), dtype=torch.long, device=dev))
                feats = sam.encode(torch.empty((1, size, size, 3), device=dev))
                sam.decode(feats, torch.empty((self.cfg["detector"]["max_boxes"], 4), device=dev))
        return {"seg_" + tag: n for tag, n in cnt.ops.items()}

    def work(self) -> dict:
        """Operations of one request by tag: ``fusion``'s and the preview
        decode's (``preview_``) in ``loop``, and the segmentation's."""
        total = self.seg_work()
        if self.loop:
            image = super().work()
            total.update(image)
            total.update({"preview_" + tag[4:]: n for tag, n in image.items() if tag.startswith("vae_")})
        return total

    # -- the check ---------------------------------------------------------------------

    @torch.no_grad()
    def check(self, reservoir, control: dict | None = None):
        """(the compared numbers, the control's or None; module docstring)."""
        out, ctl = self.check_segmentation(reservoir, control)
        if not self.loop:
            return out, ctl
        for kept in reservoir.kept:
            self.fg = self.seg.masks[kept["slot"]]  # the program's own region masks
            got, got_ctl = super().check(SimpleNamespace(kept=[kept]), control)
            for numbers, new in ((out, got), (ctl, got_ctl)):
                if numbers is not None:
                    for k, v in new.items():
                        numbers[k] = max(numbers.get(k, 0.0), v)
            out["update_rel"] = max(out["update_rel"], self.preview_gap(kept["slot"]))
        return out, ctl

    def preview_gap(self, slot: int) -> float:
        """The recorded preview latent against the plain Tweedie of the last
        jumping call from its recorded input and prediction, relative to
        the plain value's largest."""
        rec, s = self.recorder, self.S
        j = max(i for i, p in enumerate(self.plain.calls()) if p == "joint")
        if j >= len(rec.meta[slot]):
            return float("inf")
        t = rec.meta[slot][j][0]
        e = rec.eps[slot, j, :2 * s]
        x0 = self.plain.tweedie(rec.x[slot, j], cfg_mix(e[:s], e[s:], self.plain.cfg["guidance_scale"]),
                                self.plain.alpha(t))
        return rel_max(self.seg.latent[slot], x0)

    def check_segmentation(self, reservoir, control):
        """``box_abs``, ``seg_rel`` and in ``loop`` ``preview_abs`` over the kept
        requests, and the control's (TF32 in the parts that
        ``control["tf32"]`` names, and in the preview decode)."""
        sam, det = seg_reference(self.cfg)
        sam_w, det_w = draw_seg_weights(self.cfg, self.seed, self.device)
        sam.load_state_dict(sam_w, assign=True)
        det.load_state_dict(det_w, assign=True)
        tf32 = set((control or {}).get("tf32", ()))
        thr = self.cfg["detector"]["box_threshold"]
        rec = self.seg
        names = SEGMENTATION + (PREVIEW if self.loop else ())
        out = dict.fromkeys(names, 0.0)
        ctl = dict(out) if control else None

        def worst(numbers, key, value):
            numbers[key] = max(numbers[key], value)

        if self.loop:
            vae = self.reference_models()[1]
            vae.load_state_dict(weights.draw(weights.shapes_of(vae), DTYPES[self.cfg["vae"]["dtype"]],
                                             self.seed, 200, self.device), assign=True)
            factor = self.cfg["segmentation"]["preview_scaling_factor"]
        for kept in reservoir.kept:
            slot = kept["slot"]
            if rec.count[slot] != len(self.phrases):
                for numbers in (out, ctl):
                    if numbers is not None:
                        numbers.update(dict.fromkeys(names, float("inf")))
                continue
            image = rec.image[slot]
            if self.loop:
                want = preview_decode(vae, rec.latent[slot], factor)[0]
                worst(out, "preview_abs", float((image - want).abs().max()))
                if control:
                    with ref_ops.tf32(True):
                        lower = preview_decode(vae, rec.latent[slot], factor)[0]
                    worst(ctl, "preview_abs", float((lower - want).abs().max()))
            masks = []
            for p, phrase in enumerate(self.phrases):
                boxes, scores, logits = rec.boxes[slot, p], rec.scores[slot, p], rec.logits[slot, p]
                ref_boxes, ref_scores = det.detect(image, phrase)
                want, _ = ref_sam.mask_logits(sam, image, boxes)
                got = dict(box_abs=box_gap(boxes, scores, ref_boxes, ref_scores),
                           seg_rel=rel_l2(logits, want))
                for k, v in got.items():
                    worst(out, k, v)
                line = f"check: request {kept['index']} phrase {phrase!r}: {got}, top score {float(scores[0])!r}"
                if control:
                    with ref_ops.tf32("detector" in tf32):
                        low_boxes, low_scores = ref_owlvit.top(*det.detect(image, phrase), scores.shape[0])
                    with ref_ops.tf32("image_encoder" in tf32):
                        low_feats = sam.encode(ref_sam.sam_pixels(image, self.cfg["sam"]["image_size"]))
                    lower, _ = ref_sam.mask_logits(sam, image, boxes, feats=low_feats)
                    got = dict(box_abs=box_gap(low_boxes, low_scores, ref_boxes, ref_scores),
                               seg_rel=rel_l2(lower, want))
                    for k, v in got.items():
                        worst(ctl, k, v)
                    line += f"; control {got}"
                print(line, file=sys.stderr)
                del want
                mask = ref_sam.best_mask(logits, scores, thr)
                masks.append(mask)
                image = ref_sam.blackout(image, mask)
            worst(out, "seg_rel", rel_l2(rec.masks[slot], ref_sam.region_masks(masks)))
        del sam, det
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out, ctl
