"""The torch port's tokenizers and CLIP text towers against the JAX package
on the CPU.

Parameters and token ids come from numpy seeds and go through both
packages. Tolerances: token ids exact; tower outputs 1e-5 (atol and rtol)
in fp32.
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models.convert import clip_params_to_hf_state_dict
from tweediemix_tpu.utils import tokenizer as jax_tok
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models.convert import clip_torch_name, load_params
from tweediemix_tpu_torch.utils import tokenizer as port_tok

TOL = 1e-5


def make_toy_bpe():
    """Tiny CLIP-style vocab: bytes, bytes with </w>, a few merges, BOS/EOS
    (the toy vocab of the JAX package's tokenizer tests)."""
    chars = list(port_tok.bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    n = len(vocab)
    for i, c in enumerate(chars):
        vocab[c + "</w>"] = n + i
    merges = ["c a", "ca t</w>", "d o", "do g</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


PROMPTS = [
    "photo of a <cat1> cat running",
    "a <dog1> dog and a CAT, on the grass!",
    "blurry, ugly, black, low res, unrealistic, blurry face",
    "",
    " ".join(["cat dog"] * 60),  # past 77 tokens: truncated
    "it's a dog's life &amp; 42 cats",
]


@pytest.mark.parametrize("layout", ["merges", "merges_gz_pad_bang"])
def test_bpe_tokenizer_from_dir_matches_jax(tmp_path, layout):
    vocab, merges = make_toy_bpe()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    text = "#version: 0.2\n" + "\n".join(merges) + "\n"
    if layout == "merges":
        (tmp_path / "merges.txt").write_text(text)
    else:
        with gzip.open(tmp_path / "merges.txt.gz", "wt", encoding="utf-8") as f:
            f.write(text)
        # SDXL's second tokenizer pads with "!"
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"pad_token": {"content": "!"}}))
    want = jax_tok.CLIPBPETokenizer.from_dir(str(tmp_path))
    got = port_tok.CLIPBPETokenizer.from_dir(str(tmp_path))
    assert got.pad_token_id == want.pad_token_id
    assert got.pad_token_id == (vocab["!"] if layout != "merges" else vocab["<|endoftext|>"])
    for tok in (want, got):
        assert tok.add_tokens(["<cat1>", "<dog1>"]) == 2
        assert tok.add_tokens("<cat1>") == 0
    assert len(got) == len(want) == len(vocab) + 2
    for t in ("<cat1>", "<dog1>", "cat</w>", "unknown"):
        assert got.convert_tokens_to_ids(t) == want.convert_tokens_to_ids(t)
    ids = got(PROMPTS)
    assert ids == want(PROMPTS)
    assert all(len(row) == 77 for row in ids)
    at = ids[0].index(got.convert_tokens_to_ids("<cat1>"))
    assert ids[0][at + 1] == vocab["cat</w>"]
    assert ids[4][-1] == got.eos_token_id  # truncated row still ends in EOS


def test_hash_tokenizer_matches_jax():
    want, got = jax_tok.HashTokenizer(1000), port_tok.HashTokenizer(1000, pad_with_eos=True)
    for tok in (want, got):
        tok.add_tokens(["<cat1>", "<dog1>"])
    assert got(PROMPTS) == want(PROMPTS)
    assert len(got) == len(want) == 1002
    assert got.convert_tokens_to_ids("<dog1>") == 1001
    bang_w, bang_g = jax_tok.HashTokenizer(500, pad_with_eos=False), port_tok.HashTokenizer(
        500, pad_with_eos=False)
    assert bang_g(PROMPTS[:2]) == bang_w(PROMPTS[:2])


# -- CLIP towers -----------------------------------------------------------------


def numpy_params(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['embedding']"):
            return rng.standard_normal(s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def tower_pair(cfg_kw, seed):
    jcfg = jax_clip.CLIPTextConfig.tiny(**cfg_kw)
    model = jax_clip.CLIPTextModel(jcfg)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 77), np.int32))
    params = numpy_params(abstract["params"], seed)
    port = port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(**cfg_kw), device="cpu")
    load_params(port, params, name_fn=clip_torch_name)
    return model, params, port


def token_rows(rng, eos, b=4, t=77, vocab=990):
    """Rows padded like both SDXL tokenizers: EOS then EOS padding (tower
    1), EOS then "!"=0 padding (tower 2), a row with no EOS, a full row."""
    ids = rng.integers(1, vocab, size=(b, t))
    ids[0, 9:] = eos
    ids[1, 5] = eos
    ids[1, 6:] = 0
    ids[3, -1] = eos
    return ids.astype(np.int32)


@pytest.mark.parametrize("cfg_kw", [{}, dict(hidden_act="gelu", projection_dim=24)],
                         ids=["quick_gelu", "gelu_projection"])
def test_clip_text_model_matches_jax(cfg_kw):
    model, params, port = tower_pair(cfg_kw, seed=11)
    ids = token_rows(np.random.default_rng(0), eos=999)
    want = model.apply({"params": params}, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    for name, g, w in zip(("penultimate", "final", "pooled", "penultimate_ln"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)
    if "projection_dim" not in cfg_kw:
        # pooling reads the FIRST EOS (row 0 is EOS from position 9 on), and
        # position 0 of a row without one
        np.testing.assert_array_equal(got[2][0].numpy(), got[1][0, 9].numpy())
        np.testing.assert_array_equal(got[2][2].numpy(), got[1][2, 0].numpy())


def test_dual_encoder_surgery_and_tower_state_match_jax():
    j1, p1, t1 = tower_pair({}, seed=1)
    j2, p2, t2 = tower_pair(dict(hidden_size=48, num_heads=4, hidden_act="gelu",
                                 projection_dim=16), seed=2)
    jtext = jax_clip.DualTextEncoder(j1.config, j2.config, p1, p2)
    ptext = port_clip.DualTextEncoder(t1, t2)
    rng = np.random.default_rng(5)

    # --train_text_encoder tower state: tower 1's table saved with one extra row
    grown = jax_clip.set_token_embedding_rows(
        jax_clip.resize_token_embeddings(p1, 1001),
        {1000: rng.standard_normal(32).astype(np.float32)})
    grown = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.01, grown)
    jtext.load_tower_state(grown, None)
    hf = {k: torch.from_numpy(np.array(v)) for k, v in clip_params_to_hf_state_dict(grown).items()}
    ptext.load_tower_state(hf, None)
    assert ptext.model1.config.vocab_size == 1001

    # modifier tokens: tower 1 at 1001, 1002 (1000 is the saved row), tower 2 at 1000, 1001
    rows1 = list(rng.standard_normal((2, 32)).astype(np.float32))
    rows2 = list(rng.standard_normal((2, 48)).astype(np.float32))
    jtext.add_modifier_tokens([1001, 1002], rows1, [1000, 1001], rows2)
    ptext.add_modifier_tokens([1001, 1002], rows1, [1000, 1001], rows2)
    table1 = ptext.model1.text_model.embeddings.token_embedding.weight
    table2 = ptext.model2.text_model.embeddings.token_embedding.weight
    assert table1.shape[0] == 1003 and table2.shape[0] == 1002
    np.testing.assert_array_equal(table1[1001].detach().numpy(), rows1[0])
    np.testing.assert_array_equal(table2[1001].detach().numpy(), rows2[1])

    ids1 = token_rows(rng, eos=999)
    ids2 = token_rows(rng, eos=999)
    ids1[:, 1], ids1[2, 3] = 1002, 1000
    ids2[:, 2] = 1001
    want_ctx, want_pooled = jtext.encode_ids(jnp.asarray(ids1), jnp.asarray(ids2))
    got_ctx, got_pooled = ptext.encode_ids(ids1, ids2)
    assert got_ctx.shape == (4, 77, 32 + 48) and got_pooled.shape == (4, 16)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), atol=TOL, rtol=TOL)

    # find_disc probe on the grown table
    emb = np.asarray(table1[1001].detach())
    want_ids, want_scores = jax_clip.nearest_tokens(emb, np.asarray(table1.detach()), top_k=3)
    got_ids, got_scores = port_clip.nearest_tokens(emb, table1.detach(), top_k=3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=TOL)


def test_resize_token_embeddings_draws_from_the_generator():
    _, _, port = tower_pair({}, seed=3)
    before = port.text_model.embeddings.token_embedding.weight.detach().clone()
    gen = torch.Generator().manual_seed(7)
    port_clip.resize_token_embeddings(port, 1004, generator=gen)
    table = port.text_model.embeddings.token_embedding.weight.detach()
    assert table.shape == (1004, 32) and port.config.vocab_size == 1004
    torch.testing.assert_close(table[:1000], before, rtol=0, atol=0)
    want = 0.01 * torch.randn(4, 32, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(table[1000:], want, rtol=0, atol=0)
    port_clip.resize_token_embeddings(port, 900)  # never shrinks
    assert port.config.vocab_size == 1004


def test_clip_config_presets_match_jax():
    for name in ("sdxl_text_encoder", "sdxl_text_encoder_2", "i2vgen_text_encoder", "tiny"):
        want = dataclasses.asdict(getattr(jax_clip.CLIPTextConfig, name)())
        got = dataclasses.asdict(getattr(port_clip.CLIPTextConfig, name)())
        for d in (want, got):
            d.pop("dtype")
        assert got == want, name
    # remat (what --train_text_encoder takes beside the UNet's) builds and
    # computes what the plain tower computes, gradients included
    torch.manual_seed(0)
    plain = port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(), device="cpu")
    remat = port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    ids = torch.tensor([[998, 5, 17, 999] + [999] * 73])
    outs = [m(ids) for m in (plain, remat)]
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
    grads = [torch.autograd.grad(o[0].square().sum() + o[2].sum(), list(m.parameters()))
             for o, m in zip(outs, (plain, remat))]
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
