"""Tiny forms of the benchmark's cells for the CPU tests: the configuration
files with the widths and depth shrunk, the workload files as they are."""

from __future__ import annotations

import copy

from benchmark.harness import load_cell

FUSION = "sdxl-fusion-n3.bf16-1seed"
W8A8 = "sdxl-fusion-n3.w8a8-1seed"
VIDEO = "i2vgen-xl.bf16-clip"


def tiny_fusion(cell: str = FUSION, dtype: str = "float32"):
    wl, cfg = copy.deepcopy(load_cell(cell))
    cfg["unet"].update(
        sample_size=8, block_out_channels=[32, 64], down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
        up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"], layers_per_block=1,
        transformer_layers_per_block=[1, 2], attention_head_dim=[2, 4], cross_attention_dim=32,
        norm_num_groups=8, addition_time_embed_dim=8, projection_class_embeddings_input_dim=32 + 48,
        dtype=dtype)
    cfg["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
    cfg["sampling"].update(n_timesteps=6, t_cond=0.5, resampling_steps=1, jumping_steps=1,
                           height=64, width=64)
    cfg["text"].update(tokens=8, dim=32, pooled_dim=32)
    return cell, wl, cfg


def tiny_video(cell: str = VIDEO, dtype: str = "float32"):
    wl, cfg = copy.deepcopy(load_cell(cell))
    cfg["unet"].update(
        block_out_channels=[32, 64], down_block_types=["CrossAttnDownBlock3D", "DownBlock3D"],
        up_block_types=["UpBlock3D", "CrossAttnUpBlock3D"], layers_per_block=1, attention_head_dim=16,
        cross_attention_dim=32, norm_num_groups=8, context_pool_size=4, dtype=dtype)
    cfg["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
    cfg["sampling"].update(n_timesteps=4, num_frames=4, height=64, width=64, injection_timestep=0.3)
    cfg["text"].update(tokens=8, dim=32)
    return cell, wl, cfg
