"""The port's weight-only quantized serving slice
(``paddle_hackathon_tpu_torch``: ``nn/quant``, ``save_for_serving``,
``load_for_serving``, and the engines over a quantized model) against the
JAX package's, on a tiny GPT (2 layers, hidden 128, 4 heads, vocab 128,
so that every projection's K and N reach the kernel's 128-multiples).

- The quantizer gives the JAX package's bits (int8, fp8-e4m3 and the f32
  scales, dead channels and rounding ties included), and an artifact
  saved by either package holds the same bytes.
- Artifacts move in both directions (bf16, int8, fp8) with the same
  parameter names and dtypes; bf16 logits agree at ``rtol=atol=1e-2``
  (bf16 rounds at other points in the two frameworks:
  ``tests/test_torch_flash_attention.py``'s bf16 tolerance), f32 at
  ``atol=1e-5`` (the same products summed in other orders).
- Greedy serving from a shared f32 int8 artifact is token-exact: the
  port's dense and paged engines against the port's and JAX's
  ``generate``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.inference import serving as jserving
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.nn.quant import weight_only as jwo
from paddle_hackathon_tpu_torch.incubate.nn.kernels import quant_matmul as tqm
from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                  TornArtifactError,
                                                  load_for_serving,
                                                  save_for_serving)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn import Linear
from paddle_hackathon_tpu_torch.nn import quant as twq
from paddle_hackathon_tpu_torch.utils import load_jax_state, state_to_numpy
from paddle_hackathon_tpu_torch.utils.convert import (dtype_name, to_stored,
                                                      to_tensor)

_CFG = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
F32_TOL = dict(rtol=0, atol=1e-5)
_PROJ = ("attn.qkv_proj", "attn.out_proj", "mlp.fc_in", "mlp.fc_out")


def _jax_model(dtype="float32", **over):
    paddle.seed(3)
    jm = JGPT(JConfig(**dict(_CFG, **over)))
    jm.eval()
    if dtype == "bfloat16":
        for _, p in jm.named_parameters():
            if jnp.issubdtype(p._value.dtype, jnp.floating):
                p._set_value(p._value.astype(jnp.bfloat16))
    return jm


def _jax_arrays(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(jm, dtype="float32", **over):
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(_CFG, **over)),
                             device="cpu", dtype=dtype)
    load_jax_state(tm, _jax_arrays(jm))
    return tm


def _bits(a):
    """The raw bytes of an array or tensor, as unsigned integers."""
    a = to_stored(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 128, shape).astype(
        np.int32)


def _jax_logits(jm, ids):
    return np.asarray(jm(Tensor(jnp.asarray(ids))).numpy()).astype(
        np.float32)


def _port_logits(tm, ids):
    with torch.no_grad():
        return tm(torch.from_numpy(ids)).float().numpy()


# ------------------------------------------------------------- quantizer
def _weight(src):
    rng = np.random.RandomState(0)
    w = rng.randn(96, 160).astype(np.float32) * 0.1
    w[:, 7] = 0.0                    # dead channel: absmax 0
    w[:4, 3] = [127.0, 0.5, 1.5, -2.5]   # scale 1: int8 rounding ties
    w[:, 3] = np.clip(w[:, 3], -127.0, 127.0)
    w[5, 9] = 300.0                  # one outlier sets a channel's scale
    return w.astype(ml_dtypes.bfloat16) if src == "bfloat16" else w


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_quantize_array_bits_match_jax(scheme, src):
    w = _weight(src)
    jq, js = jwo.quantize_array(jnp.asarray(w), scheme)
    tq, ts = twq.quantize_array(to_tensor(w), scheme)
    assert dtype_name(tq.dtype) == np.asarray(jq).dtype.name
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert float(tq[:, 7].float().abs().max()) == 0.0
    if scheme == "int8":
        np.testing.assert_array_equal(tq[:4, 3].numpy(), [127, 0, 2, -2])


def test_quantize_weights_manifest_matches_jax():
    rng = np.random.RandomState(4)
    arrays = {
        "gpt.blocks.0.attn.qkv_proj.weight": rng.randn(8, 24),
        "gpt.wte.weight": rng.randn(16, 8),
        "gpt.ln_f.weight": np.ones(8),
        "gpt.blocks.0.attn.qkv_proj.bias": np.zeros(24),
    }
    arrays = {k: v.astype(ml_dtypes.bfloat16) for k, v in arrays.items()}
    for scheme in ("int8", "fp8"):
        jout, jman = jwo.quantize_weights(
            {k: jnp.asarray(v) for k, v in arrays.items()}, scheme)
        tout, tman = twq.quantize_weights(
            {k: to_tensor(v) for k, v in arrays.items()}, scheme)
        assert tman == jman == ["gpt.blocks.0.attn.qkv_proj.weight"]
        assert sorted(tout) == sorted(jout)
        for k in jout:
            np.testing.assert_array_equal(_bits(tout[k]), _bits(jout[k]))
        # embeddings and 1-D params untouched; quantizing twice is a no-op
        assert tout["gpt.wte.weight"].dtype == torch.bfloat16
        assert twq.quantize_weights(tout, scheme)[1] == []


def test_resolve_scheme_matches_jax():
    for name in (None, "int8", "fp8", "fp8-e4m3"):
        assert twq.resolve_scheme(name) == jwo.resolve_scheme(name)
    assert twq.resolve_scheme("fp8") == "fp8-e4m3"
    for bad in ("int4", "fp8-e5m2"):
        with pytest.raises(ValueError):
            twq.resolve_scheme(bad)


def test_apply_weight_only_live_path_respects_embedding_names():
    """The predicate sees the real dotted path, so an embedding-like
    projection held as a plain Linear stays wide."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = Linear(16, 32)
            self.embed_out = Linear(32, 32)

        def forward(self, x):
            return self.embed_out(self.proj(x))

    net = Net()
    for lay in (net.proj, net.embed_out):
        torch.nn.init.normal_(lay.weight)
    bias = net.proj.bias
    assert twq.apply_weight_only(net) == 1
    assert type(net.proj) is twq.WeightOnlyLinear
    assert type(net.embed_out) is Linear
    assert net.proj.bias is bias               # shared, not copied
    assert net(torch.randn(3, 16)).shape == (3, 32)


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_apply_weight_only_in_place_matches_jax(scheme):
    """Both packages quantize the live tiny GPT's 8 projections to the
    same bits and leave the embeddings alone; logits then agree."""
    jm = _jax_model()
    tm = _port_model(jm)
    assert jwo.apply_weight_only(jm, scheme) == 8
    assert twq.apply_weight_only(tm, scheme) == 8
    assert type(tm.gpt.wte) is not twq.WeightOnlyLinear
    jstate = _jax_arrays(jm)
    tstate = dict(tm.named_parameters())
    assert sorted(jstate) == sorted(tstate)
    for k in jstate:
        np.testing.assert_array_equal(_bits(tstate[k]), _bits(jstate[k]))
    ids = _ids((2, 9))
    np.testing.assert_allclose(_port_logits(tm, ids), _jax_logits(jm, ids),
                               **F32_TOL)


def test_apply_weight_only_names_installs_shells():
    jm = _jax_model()
    tm = _port_model(jm)
    names = [f"gpt.blocks.{i}.{p}.weight" for i in range(2) for p in _PROJ]
    bias = tm.gpt.blocks[1].mlp.fc_out.bias
    assert twq.apply_weight_only(tm, "fp8", names=names) == 8
    lay = tm.gpt.blocks[1].mlp.fc_out
    assert type(lay) is twq.WeightOnlyLinear and lay.bias is bias
    assert lay.weight.dtype == torch.float8_e4m3fn
    assert lay.weight.shape == (512, 128) and not lay.weight.requires_grad
    assert float(lay.weight.float().abs().max()) == 0.0     # empty shell
    assert torch.equal(lay.weight_scale, torch.ones(128))


def test_qat_export_is_not_ported():
    """The QAT export is ported now (its cases against the JAX package
    are in ``tests/test_torch_qat.py``): a tree without a QAT layer
    converts nothing, and a ``QuantizedLinear`` becomes a
    ``WeightOnlyLinear`` sharing its bias."""
    assert twq.convert_to_weight_only(torch.nn.Linear(2, 2)) == 0
    q = twq.QuantizedLinear(Linear(128, 256, device="cpu"))
    torch.nn.init.normal_(q.weight)
    q(torch.ones(2, 128))
    lay = twq.WeightOnlyLinear.from_qat(q)
    assert type(lay) is twq.WeightOnlyLinear and lay.bias is q.bias
    assert lay.weight.dtype == torch.int8


def test_weight_scale_must_be_per_output_channel():
    lay = twq.WeightOnlyLinear(128, 256)
    with pytest.raises(ValueError, match="per-output-channel"):
        lay._load_quantized(torch.zeros(128, 256, dtype=torch.int8),
                            torch.ones(1))


# ------------------------------------------------------- config, convert
def test_gpt_config_takes_the_jax_fields():
    jfields = dataclasses.asdict(JConfig())
    cfg = tgpt.GPTConfig(**jfields)
    assert dataclasses.asdict(cfg) == jfields
    moe = dict(jfields, moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**moe), device="cpu")


def test_convert_takes_and_gives_int8_and_fp8():
    """load_jax_state copies JAX's int8 and fp8 (ml_dtypes) arrays bit for
    bit; state_to_numpy hands fp8 back as ml_dtypes.float8_e4m3fn."""
    jm = _jax_model()
    jwo.apply_weight_only(jm, "fp8")
    arrays = _jax_arrays(jm)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    twq.apply_weight_only(tm, "fp8", names=[
        f"gpt.blocks.{i}.{p}.weight" for i in range(2) for p in _PROJ])
    load_jax_state(tm, arrays)
    back = state_to_numpy(tm)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype, k
        np.testing.assert_array_equal(_bits(back[k]), _bits(a))
    w8 = np.arange(-4, 4, dtype=np.int8).reshape(2, 4)
    assert torch.equal(to_tensor(w8), torch.from_numpy(w8))


# ---------------------------------------------------------------- artifacts
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_saved_artifacts_are_byte_identical(tmp_path, quant):
    """The same bf16 weights saved by either package: the same config.json
    and the same bytes in every params.npz entry."""
    jm = _jax_model("bfloat16")
    tm = _port_model(jm, "bfloat16")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jserving.save_for_serving(jm, jd, quant=quant)
    save_for_serving(tm, td, quant=quant)
    metas = [json.load(open(os.path.join(d, "config.json")))
             for d in (jd, td)]
    assert metas[0] == metas[1]
    if quant:
        assert len(metas[1]["quant"]["params"]) == 8
    jz, tz = (np.load(os.path.join(d, "params.npz")) for d in (jd, td))
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        np.testing.assert_array_equal(jz[k], tz[k])


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifact_loads_in_both_packages(tmp_path, writer, quant):
    jm = _jax_model("bfloat16")
    d = str(tmp_path / "a")
    if writer == "jax":
        jserving.save_for_serving(jm, d, quant=quant)
    else:
        save_for_serving(_port_model(jm, "bfloat16"), d, quant=quant)
    tq = load_for_serving(d, device="cpu")
    jq = jserving.load_for_serving(d)
    jstate = _jax_arrays(jq)
    tstate = dict(tq.named_parameters())
    assert sorted(jstate) == sorted(tstate)
    for k, a in jstate.items():
        assert dtype_name(tstate[k].dtype) == a.dtype.name, k
        np.testing.assert_array_equal(_bits(tstate[k]), _bits(a))
    blk = tq.gpt.blocks[0]
    if quant:
        assert type(blk.mlp.fc_in) is twq.WeightOnlyLinear
        assert blk.mlp.fc_in.weight.dtype == (
            torch.int8 if quant == "int8" else torch.float8_e4m3fn)
    assert tq.gpt.wte.weight.dtype == torch.bfloat16
    ids = _ids((2, 10))
    np.testing.assert_allclose(_port_logits(tq, ids), _jax_logits(jq, ids),
                               **BF16_TOL)


def test_load_for_serving_defaults_to_the_card(tmp_path):
    jm = _jax_model()
    d = str(tmp_path / "a")
    jserving.save_for_serving(jm, d, quant="int8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_for_serving(d)
    assert load_for_serving(d, device="cpu").device.type == "cpu"


def test_torn_artifacts_refuse_and_old_survives(tmp_path):
    tm = _port_model(_jax_model())
    d = str(tmp_path / "a")
    save_for_serving(tm, d)
    for victim in ("config.json", "params.npz"):
        bad = str(tmp_path / f"torn_{victim}")
        save_for_serving(tm, bad)
        os.remove(os.path.join(bad, victim))
        with pytest.raises(TornArtifactError, match=victim):
            load_for_serving(bad, device="cpu")
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write('{"model": "GPTForCaus')
    with pytest.raises(TornArtifactError, match="does not parse"):
        load_for_serving(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_for_serving(str(tmp_path / "nowhere"), device="cpu")
    # a crash inside the swap window leaves only path.old: serve that
    good = str(tmp_path / "b")
    save_for_serving(tm, good, quant="int8")
    os.rename(good, good + ".old")
    assert type(load_for_serving(good, device="cpu").gpt.blocks[0]
                .attn.qkv_proj) is twq.WeightOnlyLinear


def test_resave_keeps_sidecars_and_sweeps_dead_tmp_dirs(tmp_path):
    tm = _port_model(_jax_model())
    d = str(tmp_path / "a")
    save_for_serving(tm, d)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        f.write("{}")
    dead = f"{d}.saving-999999999-deadbeef"   # no such pid
    os.makedirs(dead)
    live = f"{d}.saving-{os.getpid()}-cafecafe"   # this process: kept
    os.makedirs(live)
    save_for_serving(tm, d, quant="int8")
    assert sorted(os.listdir(d)) == ["config.json", "params.npz",
                                     "tokenizer.json"]
    assert not os.path.exists(dead) and os.path.isdir(live)
    assert not os.path.exists(d + ".old")
    assert json.load(open(os.path.join(d, "config.json")))["quant"][
        "scheme"] == "int8"


def test_int8_artifact_weight_bytes_ratio(tmp_path):
    """On a projection-dominated shape the int8 artifact holds <= 0.55x the
    bf16 artifact's bytes, scales included (the JAX bound)."""
    tm = _port_model(_jax_model(num_layers=3), "bfloat16", num_layers=3)
    sizes = {}
    for quant in (None, "int8"):
        d = str(tmp_path / str(quant))
        save_for_serving(tm, d, quant=quant)
        z = np.load(os.path.join(d, "params.npz"))
        sizes[quant] = sum(z[k].nbytes for k in z.files)
    assert sizes["int8"] / sizes[None] <= 0.55, sizes


def test_logit_error_bound_int8_vs_bf16(tmp_path):
    """Weight-only PTQ keeps quality: int8-vs-bf16 logits within 0.05 (a
    broken scale path errs by O(|logits|))."""
    tm = _port_model(_jax_model("bfloat16"), "bfloat16")
    d = str(tmp_path / "q")
    save_for_serving(tm, d, quant="int8")
    tq = load_for_serving(d, device="cpu")
    ids = _ids((1, 12))
    err = np.abs(_port_logits(tm, ids) - _port_logits(tq, ids)).max()
    assert 0 < err < 0.05, err


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def shared_int8(tmp_path_factory):
    """One f32 int8 artifact written by JAX, loaded by both packages, and
    JAX's greedy generate on it for 3 prompts."""
    d = str(tmp_path_factory.mktemp("shared") / "q")
    jserving.save_for_serving(_jax_model(), d, quant="int8")
    jq = jserving.load_for_serving(d)
    prompts = [np.random.RandomState(5).randint(0, 128, (n,)).astype(
        np.int32) for n in (6, 9, 5)]
    refs = [np.asarray(jq.generate(Tensor(jnp.asarray(p[None])),
                                   max_new_tokens=8,
                                   temperature=0.0).numpy())[0]
            for p in prompts]
    return load_for_serving(d, device="cpu"), jq, prompts, refs


def test_quantized_forward_matches_jax_f32(shared_int8):
    tq, jq, _, _ = shared_int8
    ids = _ids((2, 11), seed=1)
    np.testing.assert_allclose(_port_logits(tq, ids), _jax_logits(jq, ids),
                               **F32_TOL)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_quantized_engines_token_exact(shared_int8, mode):
    tq, _, prompts, refs = shared_int8
    before = tqm.launches
    kw = dict(cache_mode="paged", page_size=8) if mode == "paged" else {}
    eng = ServingEngine(tq, auto_run=False, max_slots=4, max_len=64,
                        chunk=4, **kw)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run_until_idle()
    for r, p, ref in zip(reqs, prompts, refs):
        assert r.done
        np.testing.assert_array_equal(r.result(), ref)
        np.testing.assert_array_equal(
            r.result(), tq.generate(p[None], 8, temperature=0.0)[0].numpy())
    assert tqm.launches == before            # CPU: the plain version
    eng.shutdown()
