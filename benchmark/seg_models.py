"""The in-loop segmentation configuration's SAM and OWL-ViT as the
benchmark builds them, shared by ``systems/langsam.py`` and the port's
reference tests: the program's configs from the configuration's blocks,
the plain models on ``meta``, and their named tensors drawn from a seed."""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import owlvit as ref_owlvit
from benchmark.reference import sam as ref_sam
from benchmark.systems.record import DTYPES

SAM_STREAM, DETECTOR_STREAM, FOURIER_STREAM = 300, 301, 302
FOURIER = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"


def program_sam_config(cfg: dict):
    from tweediemix_tpu_torch.segmentation.sam import SAMConfig

    s = cfg["sam"]
    d = s["prompt_embed_dim"]
    fixed = (s["mlp_ratio"], s["transformer_mlp_dim"], s["iou_head_depth"], s["iou_head_hidden_dim"])
    if fixed != (4, 8 * d, 3, d):
        raise ValueError(f"the program's SAM holds MLPs of 4x, 8x and depth 3 at width {d}: {fixed}")
    return SAMConfig(
        image_size=s["image_size"], patch_size=s["vit_patch_size"], encoder_dim=s["encoder_embed_dim"],
        encoder_layers=s["encoder_depth"], encoder_heads=s["encoder_num_heads"],
        window_size=s["window_size"], global_attn_indexes=tuple(s["encoder_global_attn_indexes"]),
        prompt_dim=d, decoder_layers=s["transformer_depth"],
        attention_downsample_rate=s["attention_downsample_rate"],
        decoder_heads=s["transformer_num_heads"], num_mask_tokens=s["num_multimask_outputs"] + 1,
        dtype=DTYPES[s["dtype"]])


def program_detector_config(cfg: dict):
    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from tweediemix_tpu_torch.segmentation.detector import DetectorConfig

    d = cfg["detector"]
    v, t, dt = d["vision_config"], d["text_config"], DTYPES[d["dtype"]]
    return DetectorConfig(
        vision=CLIPVisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], hidden_act=v["hidden_act"], projection_dim=None,
            dtype=dt),
        text=CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"], num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"], max_positions=t["max_position_embeddings"],
            hidden_act=t["hidden_act"], projection_dim=d["projection_dim"],
            eos_token_id=t["eos_token_id"], dtype=dt),
        embed_dim=d["projection_dim"], max_boxes=d["max_boxes"])


def seg_reference(cfg: dict):
    """The plain SAM and OWL-ViT, on ``meta``."""
    with torch.device("meta"):
        return ref_sam.SAM(cfg["sam"]), ref_owlvit.OwlViT(cfg["detector"])


def draw_seg_weights(cfg: dict, seed: int, device):
    """(SAM's, OWL-ViT's) named tensors from the seed: ``weights.draw``, and
    SAM's random Fourier matrix N(0, 1) as upstream draws it."""
    sam, det = seg_reference(cfg)
    sam_w = weights.draw(weights.shapes_of(sam), DTYPES[cfg["sam"]["dtype"]], seed, SAM_STREAM, device)
    sam_w[FOURIER] = weights.normal(sam_w[FOURIER].shape, 1.0, seed, FOURIER_STREAM, device)
    det_w = weights.draw(weights.shapes_of(det), DTYPES[cfg["detector"]["dtype"]], seed,
                         DETECTOR_STREAM, device)
    return sam_w, det_w
