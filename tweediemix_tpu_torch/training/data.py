"""The training input pipeline: the Custom-Diffusion dataset with its
random-scale paste augmentation (counterpart of
``tweediemix_tpu/training/data.py``).

* per-concept instance and class image lists (a ``concepts_list``);
* instance rows: an optional hflip, an aspect-preserving thumbnail to a
  random scale in [size//3, size] pasted at a random offset on a black
  size² canvas, and a latent-resolution validity mask shrunk by one latent
  pixel per side;
* class (prior) rows: an optional hflip, a shorter-side resize to ``size``,
  a random crop (a centre crop with ``center_crop``) and an all-ones mask;
* ``latent_factor`` is the VAE's downscale factor (tiny test VAEs use 2);
* ``collate`` puts the instance rows first, then the class rows.

Images are read with the port's PNG reader (other formats only where PIL
imports: ``utils/image.py::read_image`` raises naming the file otherwise).
The resize, paste and normalisation run in the built augment library
(``training/augment.py``). The random draws are those of the JAX package
on the same numpy seed. Layout: NHWC float32, masks [B, h, w, 1].
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from tweediemix_tpu_torch.training.augment import paste_augment, resize_crop_normalize, resized_dims
from tweediemix_tpu_torch.utils.image import read_image

IMAGE_SUFFIXES = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


@dataclasses.dataclass
class ConceptSpec:
    instance_data_dir: str
    instance_prompt: str
    class_data_dir: Optional[str] = None
    class_prompt: Optional[str] = None


def list_images(d: str) -> List[str]:
    return sorted(str(p) for p in Path(d).iterdir()
                  if p.is_file() and p.suffix.lower() in IMAGE_SUFFIXES)


class CustomDiffusionDataset:
    def __init__(
        self,
        concepts: List[ConceptSpec],
        tokenizer_one,
        tokenizer_two,
        size: int = 512,
        with_prior_preservation: bool = True,
        num_class_images: int = 200,
        hflip: bool = False,
        center_crop: bool = False,
        seed: int = 0,
        latent_factor: int = 8,
    ):
        self.size = size
        self.latent_factor = latent_factor
        self.with_prior = with_prior_preservation
        self.tok1 = tokenizer_one
        self.tok2 = tokenizer_two
        self.hflip = hflip
        self.center_crop = center_crop
        self.rng = np.random.default_rng(seed)

        self.instance = []
        self.cls = []
        for c in concepts:
            for p in list_images(c.instance_data_dir):
                self.instance.append((p, c.instance_prompt))
            if with_prior_preservation and c.class_data_dir and os.path.isdir(c.class_data_dir):
                for p in list_images(c.class_data_dir)[:num_class_images]:
                    self.cls.append((p, c.class_prompt))
        self.rng.shuffle(self.instance)
        self._length = max(len(self.instance), len(self.cls), 1)

    def __len__(self):
        return self._length

    def example(self, index: int) -> Dict[str, np.ndarray]:
        path, prompt = self.instance[index % len(self.instance)]
        img = read_image(path)
        if self.hflip and self.rng.random() < 0.5:
            img = img[:, ::-1]

        # an aspect-preserving thumbnail to a random scale (never enlarged)
        scale = int(self.rng.integers(self.size // 3, self.size + 1))
        ih, iw = img.shape[:2]
        factor = min(scale / max(iw, 1), scale / max(ih, 1), 1.0)
        th, tw = max(1, round(ih * factor)), max(1, round(iw * factor))
        oy = int(self.rng.integers(0, self.size - th + 1))
        ox = int(self.rng.integers(0, self.size - tw + 1))
        canvas, mask = paste_augment(img, th, tw, oy, ox, self.size, self.size // self.latent_factor)

        out = {
            "pixel_values": canvas,
            "mask": mask,
            "ids_one": np.asarray(self.tok1(prompt)[0], np.int32),
            "ids_two": np.asarray(self.tok2(prompt)[0], np.int32),
        }
        if self.with_prior and self.cls:
            cpath, cprompt = self.cls[index % len(self.cls)]
            cimg = read_image(cpath)
            if self.hflip and self.rng.random() < 0.5:
                cimg = cimg[:, ::-1]
            th, tw = resized_dims(cimg.shape[0], cimg.shape[1], self.size)
            if self.center_crop:
                cy, cx = (th - self.size) // 2, (tw - self.size) // 2
            else:
                cy = int(self.rng.integers(0, th - self.size + 1))
                cx = int(self.rng.integers(0, tw - self.size + 1))
            out["class_pixel_values"] = resize_crop_normalize(cimg, self.size, cy, cx)
            out["class_mask"] = np.ones_like(mask)
            out["class_ids_one"] = np.asarray(self.tok1(cprompt)[0], np.int32)
            out["class_ids_two"] = np.asarray(self.tok2(cprompt)[0], np.int32)
        return out

    def batches(self, batch_size: int, steps: int, start: int = 0):
        """Collated batches (instance rows first, then class rows, with
        ``is_prior``) for micro steps ``start`` .. ``start + steps``: the
        examples of earlier steps are drawn and dropped, so a resumed run
        sees what an unbroken one would."""
        for i in range(start * batch_size):
            self.example(i)
        idx = start * batch_size
        for _ in range(steps):
            rows = [self.example(i) for i in range(idx, idx + batch_size)]
            idx += batch_size
            yield collate(rows, self.with_prior and bool(self.cls))


def collate(rows: List[Dict[str, np.ndarray]], with_prior: bool) -> Dict[str, np.ndarray]:
    pixels = [r["pixel_values"] for r in rows]
    masks = [r["mask"] for r in rows]
    ids1 = [r["ids_one"] for r in rows]
    ids2 = [r["ids_two"] for r in rows]
    n_inst = len(rows)
    if with_prior:
        pixels += [r["class_pixel_values"] for r in rows]
        masks += [r["class_mask"] for r in rows]
        ids1 += [r["class_ids_one"] for r in rows]
        ids2 += [r["class_ids_two"] for r in rows]
    b = len(pixels)
    return {
        "pixel_values": np.stack(pixels),  # [B, size, size, 3]
        "mask": np.stack(masks)[..., None],  # [B, size/f, size/f, 1]
        "ids_one": np.stack(ids1),
        "ids_two": np.stack(ids2),
        "is_prior": np.concatenate([np.zeros(n_inst, np.float32),
                                    np.ones(b - n_inst, np.float32)]),
    }


def prefetch_batches(batches, depth: int = 2):
    """Run a batch iterator on a background thread, ``depth`` batches ahead
    (the reference's ``DataLoader(num_workers=...)``): the worker reads and
    augments the next batches while the card runs the current step. An
    exception on the worker is raised at the consuming ``next()``; the
    order is unchanged; an abandoned consumer stops the worker."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
