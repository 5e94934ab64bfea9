"""Real regularisation images from the LAION knn index (counterpart of
``tweediemix_tpu/training/retrieve.py``, the reference's ``retrieve.py``).

Queries ``knn.laion.ai`` (laion_400m, aesthetic weight 0.1) with a growing
result budget until ``2 * num_class_images`` distinct URLs are collected,
downloads the images and writes ``images/``, ``caption.txt``, ``urls.txt``
and ``images.txt`` beside them. Without a network it raises
``RuntimeError``, and the trainer generates class images instead.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import List

KNN_URL = "https://knn.laion.ai/knn-service"


def _query(text: str, num: int, indice: str = "laion_400m") -> List[dict]:
    payload = json.dumps({
        "text": text,
        "image": None,
        "image_url": None,
        "embedding_input": None,
        "modality": "image",
        "num_images": num,
        "indice_name": indice,
        "num_result_ids": num,
        "use_mclip": False,
        "deduplicate": True,
        "use_safety_model": True,
        "use_violence_detector": True,
        "aesthetic_score": "9",
        "aesthetic_weight": "0.1",
    }).encode()
    req = urllib.request.Request(KNN_URL, data=payload,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def retrieve(class_prompt: str, class_data_dir: str, num_class_images: int) -> int:
    """Returns the number of images written; raises RuntimeError offline."""
    target = 2 * num_class_images
    os.makedirs(os.path.join(class_data_dir, "images"), exist_ok=True)
    seen, entries = set(), []
    budget = target
    try:
        while len(entries) < target and budget <= 8 * target:
            for item in _query(class_prompt, budget):
                url = item.get("url")
                cap = item.get("caption", class_prompt)
                if url and url not in seen:
                    seen.add(url)
                    entries.append((url, cap))
            budget *= 2
    except OSError as e:
        raise RuntimeError(f"LAION retrieval unavailable (offline?): {e}") from e

    images, captions, urls = [], [], []
    for url, cap in entries:
        if len(images) >= num_class_images:
            break
        path = os.path.join(class_data_dir, "images", f"{len(images):05d}.jpg")
        try:
            urllib.request.urlretrieve(url, path)
        except OSError:
            continue
        images.append(path)
        captions.append(cap)
        urls.append(url)

    for name, lines in (("caption.txt", captions), ("urls.txt", urls), ("images.txt", images)):
        with open(os.path.join(class_data_dir, name), "w") as f:
            f.write("\n".join(lines))
    return len(images)
