"""The port's conditioners (ditsep_tpu_torch/models/conditioners.py) and
``CondRouting`` against the JAX package's, on seeded inputs with the JAX
parameters redrawn from a seed and carried over by ``params_from_jax``;
the host T5 / CLAP encoders with injected random-weight models, as
tests/test_models_extra.py:350-455 runs JAX's.

Bars: embeddings 1e-5 of max|ref|, masks and ids exact, the host encoders
bit for bit (both packages run the same torch encoder).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import conditioners as jc
from ditsep_tpu.training.diffusion import CondRouting as JRouting
from ditsep_tpu_torch.models import conditioners as tc
from ditsep_tpu_torch.training.diffusion import CondRouting
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw

BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(jmod, tmod, *args, seed=3, **kw):
    """The JAX module's (embedding, mask) and the port's on the same
    redrawn parameters."""
    params = redraw(init_shapes(jmod, *args, **kw), seed)
    want = jmod.apply(params, *args, **kw)
    load_jax(tmod, params)
    with torch.no_grad():
        got = tmod(*args, **kw)
    return got, want


def _check(got, want):
    assert max_rel(got[0], want[0]) <= BAR
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


CASES = {
    "number": (lambda: (jc.NumberConditioner(16, 0.0, 512.0),
                        tc.NumberConditioner(16, 0.0, 512.0)),
               lambda: (np.asarray([-3.0, 10.0, 47.0, 900.0], np.float32),)),
    "int": (lambda: (jc.IntConditioner(8, 2, 20),
                     tc.IntConditioner(8, 2, 20)),
            lambda: (np.asarray([0, 2, 13, 99]),)),
    "list": (lambda: (jc.ListConditioner(8, ("a", "b", "c")),
                      tc.ListConditioner(8, ("a", "b", "c"))),
             lambda: (np.asarray([2, 0, 1]),)),
    "pretransform": (lambda: (jc.PretransformConditioner(12),
                              tc.PretransformConditioner(12, 6)),
                     lambda: (_x((2, 6, 5), 1),)),
    "phoneme": (lambda: (jc.PhonemeConditioner(8),
                         tc.PhonemeConditioner(8)),
                lambda: (np.asarray([[3, 9, 40, 0, 0], [1, 2, 0, 0, 0]]),)),
    "phoneme_proj": (lambda: (jc.PhonemeConditioner(8, project_out=True),
                              tc.PhonemeConditioner(8, project_out=True)),
                     lambda: (np.asarray([[5, 6, 0], [7, 0, 0]]),)),
    "host_zero_rows": (lambda: (jc.HostEmbeddingConditioner(8),
                                tc.HostEmbeddingConditioner(8, input_dim=6)),
                       lambda: (np.concatenate([_x((2, 3, 6), 2),
                                                np.zeros((2, 2, 6),
                                                         np.float32)], 1),)),
    "host_pooled": (lambda: (jc.HostEmbeddingConditioner(8),
                             tc.HostEmbeddingConditioner(8, input_dim=6)),
                    lambda: (_x((3, 6), 3),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conditioner_matches_jax(case):
    make, inputs = CASES[case]
    jmod, tmod = make()
    _check(*_pair(jmod, tmod, *inputs()))


def test_host_embedding_prefers_the_encoder_mask():
    """With the encoder's mask the all-zero-row heuristic is not used (T5
    emits non-zero states at padding)."""
    emb = _x((2, 5, 6), 4)
    mask = np.asarray([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)
    got, want = _pair(jc.HostEmbeddingConditioner(8),
                      tc.HostEmbeddingConditioner(8, input_dim=6), emb,
                      mask=mask)
    _check(got, want)
    assert got[1].tolist() == mask.tolist()


def test_host_embedding_without_projection_passes_through():
    emb = _x((2, 4, 8), 5)
    got = tc.HostEmbeddingConditioner(8, project_out=False)(emb)
    want = jc.HostEmbeddingConditioner(8, project_out=False).apply({}, emb)
    _check(got, want)


@pytest.mark.parametrize("text", ["Hello world, this is a test.",
                                  "thought quick phone", ""])
def test_phonemes_match_jax(text):
    assert tc.text_to_phonemes(text) == jc.text_to_phonemes(text)
    ph = jc.text_to_phonemes(text) + ["XX"]
    assert tc.phonemes_to_ids(ph, 7) == jc.phonemes_to_ids(ph, 7)
    assert tc.ARPABET_PHONEMES == jc.ARPABET_PHONEMES


SA_CONDITIONING = {
    "cond_dim": 12,
    "default_keys": {"secs_total": "seconds_total"},
    "configs": [
        {"id": "prompt", "type": "t5",
         "config": {"max_length": 5, "input_dim": 6}},
        {"id": "seconds_start", "type": "number",
         "config": {"min_val": 0, "max_val": 512}},
        {"id": "secs_total", "type": "number",
         "config": {"min_val": 0, "max_val": 512}},
        {"id": "genre", "type": "list",
         "config": {"options": ["rock", "jazz"], "output_dim": 12}},
    ]}


def _multi_inputs():
    emb = _x((2, 5, 6), 6)
    mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    return {"prompt": (emb, mask),
            "seconds_start": np.asarray([0.0, 12.0], np.float32),
            "seconds_total": np.asarray([47.0, 30.0], np.float32),
            "genre": np.asarray([1, 0])}


def test_multi_conditioner_and_routing_match_jax():
    """``create_multi_conditioner_from_config`` on a Stable Audio
    Open-shaped conditioning (a T5 prompt with its mask, two numbers, one
    through ``default_keys``, a list), then ``CondRouting.gather`` into
    every model input."""
    inputs = _multi_inputs()
    cfg = dict(SA_CONDITIONING, configs=[
        dict(c, config={k: v for k, v in c["config"].items()
                        if k != "input_dim"})
        for c in SA_CONDITIONING["configs"]])
    jm = jc.create_multi_conditioner_from_config(cfg)
    jinputs = {k: ((jnp.asarray(v[0]), jnp.asarray(v[1]))
                   if isinstance(v, tuple) else jnp.asarray(v))
               for k, v in inputs.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jinputs))
    variables = redraw(shapes, 9)
    want = jm(variables, jinputs)
    tm = load_jax(tc.create_multi_conditioner_from_config(SA_CONDITIONING),
                  variables)
    with torch.no_grad():
        got = tm(inputs)
    assert set(got) == set(want)
    for k in want:
        _check(got[k], want[k])
    routing = dict(cross_attn_cond_ids=("prompt", "seconds_start",
                                        "secs_total"),
                   global_cond_ids=("seconds_start", "secs_total"),
                   input_concat_ids=("genre",),
                   prepend_cond_ids=("genre", "seconds_start"))
    gw = JRouting(**routing).gather(want)
    gg = CondRouting(**routing).gather(got)
    assert set(gg) == set(gw)
    for k in gw:
        if gw[k].dtype == bool:
            np.testing.assert_array_equal(gg[k].numpy(), np.asarray(gw[k]))
        else:
            assert max_rel(gg[k], gw[k]) <= BAR


def test_unknown_conditioner_type_raises():
    with pytest.raises(ValueError, match="unknown conditioner"):
        tc.create_multi_conditioner_from_config(
            {"configs": [{"id": "x", "type": "nope"}]})


class _StubTok:
    """The HF tokenizer call contract: texts -> a fixed-length id grid."""

    def __call__(self, texts, truncation, max_length, padding,
                 return_tensors):
        ids = torch.zeros((len(texts), max_length), dtype=torch.long)
        mask = torch.zeros_like(ids)
        for b, t in enumerate(texts):
            toks = [(sum(map(ord, w)) % 62) + 2 for w in t.split()]
            toks = toks[:max_length]
            ids[b, :len(toks)] = torch.tensor(toks)
            mask[b, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def test_t5_encode_host_with_injected_encoder():
    """The host T5 path with an injected random-weight T5 encoder equals
    JAX's bit for bit, then feeds the projection head with its mask."""
    pytest.importorskip("transformers")
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                   num_layers=1, num_heads=2)
    torch.manual_seed(0)
    enc = T5EncoderModel(cfg)
    texts = ["hello world", "a"]
    emb, mask = tc.t5_encode_host(texts, max_length=6, tokenizer=_StubTok(),
                                  encoder=enc)
    jemb, jmask = jc.t5_encode_host(texts, max_length=6,
                                    tokenizer=_StubTok(), encoder=enc)
    np.testing.assert_array_equal(emb, jemb)
    np.testing.assert_array_equal(mask, jmask)
    assert emb.shape == (2, 6, 16)
    assert mask.tolist() == [[True, True] + [False] * 4,
                             [True] + [False] * 5]
    _check(*_pair(jc.HostEmbeddingConditioner(8),
                  tc.HostEmbeddingConditioner(8, input_dim=16), emb,
                  mask=mask))


def test_clap_encode_host_with_injected_model():
    """The host CLAP text path with an injected random-weight ClapModel
    equals JAX's bit for bit, then feeds the projection head."""
    pytest.importorskip("transformers")
    from transformers import ClapConfig, ClapModel

    cfg = ClapConfig(
        text_config=dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=32, projection_dim=8),
        audio_config=dict(spec_size=64, patch_size=4, window_size=4,
                          hidden_size=16, depths=[1, 1],
                          num_attention_heads=[2, 2], num_mel_bins=16,
                          patch_embeds_hidden_size=8, projection_dim=8),
        projection_dim=8)
    torch.manual_seed(0)
    model = ClapModel(cfg)

    class StubProc:
        def __call__(self, text=None, return_tensors=None, padding=None,
                     **kw):
            return _StubTok()(text, True, 6, "max_length", "pt")

    texts = ["a dog barking", "rain"]
    emb, mask = tc.clap_encode_host(texts=texts, model=model,
                                    processor=StubProc())
    jemb, jmask = jc.clap_encode_host(texts=texts, model=model,
                                      processor=StubProc())
    np.testing.assert_array_equal(emb, jemb)
    np.testing.assert_array_equal(mask, jmask)
    assert emb.shape == (2, 1, 8) and mask.all()
    _check(*_pair(jc.HostEmbeddingConditioner(4),
                  tc.HostEmbeddingConditioner(4, input_dim=8), emb))
