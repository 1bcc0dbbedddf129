"""The port's alternate conditioning encoders (`models/encoders.py`) against
their JAX counterparts, fp32 on the CPU.

Each JAX module gets a random Flax param tree drawn with numpy; the tree is
carried across with `flax_encoder_state_dict` and strict-loaded into the
port's module; both then see the same numpy inputs. Tolerance: atol 1e-4
(fp32, tiny widths; only the order of sums differs). The T5 bucket table is
integer and must be equal. Then the pipeline's wiring of the
FrozenCLIPEmbedder role and its two rejections.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.models import encoders as jenc  # noqa: E402
from dynamicrafter_tpu.models.clip import CLIPVisionConfig as JVisionConfig  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.models import encoders as tenc  # noqa: E402
from dynamicrafter_tpu_torch.models.clip import CLIPVisionConfig  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.utils.weights import (  # noqa: E402
    flax_encoder_state_dict, load_reference_state_dict)
from test_torch_modules import randn, random_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIP_KW = dict(vocab_size=100, width=32, heads=4, layers=3, context_length=16,
               eos_token_id=99)
T5_KW = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4,
             rel_buckets=8, rel_max_distance=20)


def _carry(kind, params, module):
    load_reference_state_dict(module, flax_encoder_state_dict(kind, params))
    return module.eval()


def _tokens_with_eos(rng, vocab, b, ctx):
    toks = rng.integers(0, vocab - 1, (b, ctx))
    for i, p in enumerate(rng.integers(2, ctx, (b,))):
        toks[i, p:] = vocab - 1
    return toks.astype(np.int32)


@pytest.mark.parametrize("layer,layer_idx", [("last", None), ("pooled", None),
                                             ("hidden", -2), ("hidden", 1)])
def test_hf_clip_text_matches_jax(layer, layer_idx):
    kw = dict(CLIP_KW, layer=layer, layer_idx=layer_idx)
    jmod = jenc.HFCLIPTextEncoder(jenc.HFCLIPTextConfig(**kw))
    toks = _tokens_with_eos(np.random.default_rng(0), 100, 2, 16)
    params = random_params(jmod, toks, seed=1)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(toks)))
    tmod = _carry("clip_text_hf", params, tenc.HFCLIPTextEncoder(tenc.HFCLIPTextConfig(**kw)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(toks).long()).numpy()
    assert out.shape == ref.shape == ((2, 1, 32) if layer == "pooled" else (2, 16, 32))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_hf_clip_text_keys_are_the_hf_models():
    """The module's names are `transformers.CLIPTextModel`'s, so its
    checkpoint loads by name."""
    keys = set(tenc.HFCLIPTextEncoder(tenc.HFCLIPTextConfig(**CLIP_KW)).state_dict())
    assert {"text_model.embeddings.token_embedding.weight",
            "text_model.embeddings.position_embedding.weight",
            "text_model.encoder.layers.2.self_attn.q_proj.weight",
            "text_model.encoder.layers.0.mlp.fc1.bias",
            "text_model.encoder.layers.1.layer_norm2.weight",
            "text_model.final_layer_norm.bias"} <= keys
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=16, hidden_act="quick_gelu")
    hf = {k for k in transformers.CLIPTextModel(cfg).state_dict() if "position_ids" not in k}
    assert keys == hf


def test_hf_clip_text_rejects_bad_layer():
    with pytest.raises(ValueError, match="layer_idx"):
        tenc.HFCLIPTextEncoder(tenc.HFCLIPTextConfig(**dict(CLIP_KW, layer="hidden")))
    with pytest.raises(ValueError, match="unknown layer"):
        tenc.HFCLIPTextEncoder(tenc.HFCLIPTextConfig(**dict(CLIP_KW, layer="penultimate")))


@pytest.mark.parametrize("qlen,klen,buckets,max_distance", [
    (16, 16, 8, 20), (77, 77, 32, 128), (5, 40, 32, 128), (64, 64, 4, 10)])
def test_t5_buckets_equal(qlen, klen, buckets, max_distance):
    ours = tenc.t5_rel_buckets(qlen, klen, buckets, max_distance)
    ref = jenc._t5_rel_buckets(qlen, klen, buckets, max_distance)
    assert ours.dtype == np.int64 and ours.shape == (qlen, klen)
    np.testing.assert_array_equal(ours, ref)
    assert 0 <= ours.min() and ours.max() < buckets


def test_t5_encoder_matches_jax():
    jmod = jenc.T5Encoder(jenc.T5Config(**T5_KW))
    toks = np.random.default_rng(1).integers(0, 100, (2, 16)).astype(np.int32)
    params = random_params(jmod, toks, seed=2)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(toks)))
    tmod = _carry("t5", params, tenc.T5Encoder(tenc.T5Config(**T5_KW)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(toks).long()).numpy()
    assert out.shape == ref.shape == (2, 16, 32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_t5_keys_are_the_hf_models():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(
        vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20,
        feed_forward_proj="gated-gelu")
    hf = set(transformers.T5EncoderModel(cfg).state_dict()) - {"encoder.embed_tokens.weight"}
    assert set(tenc.T5Encoder(tenc.T5Config(**T5_KW)).state_dict()) == hf


def test_class_embedder_matches_jax():
    jmod = jenc.ClassEmbedder(embed_dim=8, n_classes=10, ucg_rate=0.5)
    ids = np.arange(6, dtype=np.int32)
    params = random_params(jmod, ids, seed=3, disable_dropout=True)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids), disable_dropout=True))
    tmod = _carry("class_embed", params, tenc.ClassEmbedder(8, n_classes=10, ucg_rate=0.5))
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        out = tmod(tids, disable_dropout=True).numpy()
        many = torch.arange(32) % 9
        drop = tmod(many, generator=torch.Generator().manual_seed(3)).numpy()
    assert out.shape == ref.shape == (6, 1, 8)
    np.testing.assert_array_equal(out, ref)
    table = np.asarray(params["embedding"]["embedding"])
    own = np.all(drop[:, 0] == table[many.numpy()], axis=-1)
    unc = np.all(drop[:, 0] == table[9], axis=-1)
    assert np.all(own | unc) and unc.any() and own.any()
    np.testing.assert_array_equal(tmod.unconditional_ids(4).numpy(),
                                  np.asarray(jmod.unconditional_ids(4)))
    with pytest.raises(ValueError, match="generator"):
        tmod(tids)


VIS_KW = dict(width=32, heads=4, layers=2, patch_size=8, image_size=32)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_vision_pooled_matches_jax(act):
    jmod = jenc.CLIPVisionPooled(JVisionConfig(**VIS_KW, act=act), output_dim=24)
    x = randn(np.random.default_rng(2), 2, 32, 32, 3)
    params = random_params(jmod, x, seed=4)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    tmod = _carry("clip_vision_pooled", params,
                  tenc.CLIPVisionPooled(CLIPVisionConfig(**VIS_KW, act=act), output_dim=24))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 24)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_clip_vision_pooled_ucg_zeroing():
    mod = tenc.CLIPVisionPooled(CLIPVisionConfig(width=16, heads=2, layers=1, patch_size=8,
                                                 image_size=16), output_dim=8)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.1, generator=gen)
        x = torch.randn(64, 16, 16, 3, generator=gen)
        base = mod(x).numpy()
        out = mod(x, generator=gen, ucg_rate=0.5).numpy()
    zeroed = np.all(out == 0, axis=-1)
    assert 10 < zeroed.sum() < 54          # per sample, all or nothing, about half
    np.testing.assert_array_equal(out[~zeroed], base[~zeroed])
    with pytest.raises(ValueError, match="generator"):
        mod(x, ucg_rate=0.5)


def test_clip_t5_joint_matches_jax_and_identity():
    ckw = dict(vocab_size=50, width=16, heads=2, layers=2, context_length=8, eos_token_id=49)
    tkw = dict(vocab_size=60, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2,
               rel_buckets=4, rel_max_distance=10)
    jmod = jenc.CLIPT5Encoder(jenc.HFCLIPTextConfig(**ckw), jenc.T5Config(**tkw))
    rng = np.random.default_rng(5)
    ct = rng.integers(0, 50, (2, 8)).astype(np.int32)
    tt = rng.integers(0, 60, (2, 8)).astype(np.int32)
    params = random_params(jmod, ct, tt, seed=6)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(ct), jnp.asarray(tt))
    tmod = _carry("clip_t5", params,
                  tenc.CLIPT5Encoder(tenc.HFCLIPTextConfig(**ckw), tenc.T5Config(**tkw)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(ct).long(), torch.from_numpy(tt).long())
    for o, r in zip(out, ref):
        assert o.shape == (2, 8, 16)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    x = torch.ones(3, 4)
    assert tenc.identity_encode(x) is x


def test_carry_is_strict():
    mod = tenc.T5Encoder(tenc.T5Config(**T5_KW))
    sd = {k: v.numpy() for k, v in mod.state_dict().items()}
    sd.pop("encoder.final_layer_norm.weight")
    with pytest.raises(KeyError, match="missing"):
        load_reference_state_dict(mod, sd)
    with pytest.raises(ValueError, match="unknown encoder kind"):
        flax_encoder_state_dict("bert", {})


# -- the pipeline's wiring (config.py's role table) ---------------------------

TINY_CLIP_TEXT = {"vocab_size": 49408, "width": 48, "heads": 4, "layers": 2,
                  "context_length": 77}


def _tiny_with_cond_stage(target, params=None, clip_text=None):
    node = copy.deepcopy(TINY_MODEL_CONFIG)
    p = node["model"]["params"]
    p["cond_stage_config"] = {"target": target, "params": params or {}}
    if clip_text is not None:
        p["clip_text_config"] = {"params": clip_text}
    return ModelConfig(node)


def test_pipeline_builds_hf_clip_text_from_config():
    cfg = _tiny_with_cond_stage("lvdm.modules.encoders.condition.FrozenCLIPEmbedder",
                                params={"layer": "pooled"}, clip_text=TINY_CLIP_TEXT)
    assert cfg.cond_stage_role == "clip_text_hf"
    pipe = DynamiCrafterPipeline(cfg, "cpu")
    assert isinstance(pipe.text_encoder.transformer, tenc.HFCLIPTextEncoder)
    assert pipe.text_encoder.config.layer == "pooled"
    # FrozenCLIPEmbedder keeps the HF model under `transformer.`
    assert ("cond_stage_model.transformer.text_model.final_layer_norm.weight"
            in pipe.net.state_dict())
    pipe.init_random(seed=0)
    z = pipe.embed_text(["a cat"])
    assert z.shape == (1, 1, 48) and bool(torch.isfinite(z).all())   # pooled: one token


def test_hf_role_pads_with_eot():
    cfg = _tiny_with_cond_stage("lvdm.modules.encoders.condition.FrozenCLIPEmbedder",
                                clip_text=TINY_CLIP_TEXT)
    pipe = DynamiCrafterPipeline(cfg, "cpu")
    toks = pipe.tokenizer(["hi"])
    eos = pipe.text_encoder.config.eos_token_id
    assert eos == 49407 and toks[0, -1] == eos and toks[0, -10] == eos
    pipe0 = DynamiCrafterPipeline(ModelConfig(copy.deepcopy(TINY_MODEL_CONFIG)), "cpu")
    assert pipe0.tokenizer(["hi"])[0, -1] == 0        # open_clip pads with 0


def test_openclip_layer_last_honoured():
    cfg = _tiny_with_cond_stage("lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder",
                                params={"layer": "last"}, clip_text=TINY_CLIP_TEXT)
    assert DynamiCrafterPipeline(cfg, "cpu").text_encoder.config.penultimate is False


@pytest.mark.parametrize("target", ["FrozenT5Embedder", "FrozenCLIPT5Encoder",
                                    "ClassEmbedder"])
def test_text_target_without_context_contract_rejected(target):
    cfg = _tiny_with_cond_stage("lvdm.modules.encoders.condition." + target)
    with pytest.raises(ValueError, match="models/encoders.py"):
        DynamiCrafterPipeline(cfg, "cpu")


@pytest.mark.parametrize("target", ["FrozenOpenCLIPImageEmbedder", "ClipImageEmbedder"])
def test_pooled_image_target_rejected_with_pointer(target):
    node = copy.deepcopy(TINY_MODEL_CONFIG)
    node["model"]["params"]["img_cond_stage_config"] = {
        "target": "lvdm.modules.encoders.condition." + target, "params": {}}
    with pytest.raises(ValueError, match="CLIPVisionPooled"):
        DynamiCrafterPipeline(ModelConfig(node), "cpu")


def test_unknown_cond_stage_target_rejected():
    with pytest.raises(ValueError, match="unrecognized conditioning target"):
        _tiny_with_cond_stage("my.custom.MysteryEncoder")
