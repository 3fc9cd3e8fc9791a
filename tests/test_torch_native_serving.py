"""The port's native serving ABI (``paddle_hackathon_tpu_torch/native/
serving.cc``: ``pht_serving_init``, ``pht_predictor_*``, ``pht_engine_*``)
against the JAX package's engine and predictor, on the CPU.

The shim is built with ``g++`` by ``native.build_serving_shim`` and linked
into a C++ client with no Python in its source.  One client process,
under ``PHT_SERVING_PLATFORM=cpu``, serves a 2-layer GPT artifact saved by
the JAX package: the predictor's f32 path (logits within 1e-5 of the JAX
``Predictor``'s), a single generation and four concurrent ones from C++
threads (tokens equal to the JAX engine's; one waits with ``timeout_s =
0``, which means forever), and the error paths (bad handles, a short
output buffer, a missing artifact) with their error strings.  Without the
variable, on a machine with no card, creation fails with an error string;
an unknown platform fails ``pht_serving_init``.  The shim's embedded code
and the port import nothing of JAX or the JAX package.
"""

import os
import re
import subprocess

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu import inference as jinf
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.inference.serving import save_for_serving
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "paddle_hackathon_tpu_torch")

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
NEW = 6

CLIENT_CC = r"""
// Pure-C++ serving client: no Python anywhere in this translation unit.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int32_t pht_serving_init(const char* repo_dir);
void* pht_predictor_create(const char* model_path);
int64_t pht_predictor_run_f32(void*, const float*, const int64_t*, int32_t,
                              float*, int64_t, int64_t*, int32_t);
const char* pht_predictor_last_error();
void pht_predictor_destroy(void*);
void* pht_engine_create(const char*, int32_t, int32_t, int32_t);
int64_t pht_engine_generate(void*, const int32_t*, int32_t, int32_t,
                            int32_t*, int64_t, double);
void pht_engine_destroy(void*);
}

static void print_tokens(const char* tag, const int32_t* t, int64_t n) {
  std::printf("%s:", tag);
  for (int64_t i = 0; i < n; i++) std::printf(" %d", t[i]);
  std::printf("\n");
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  std::string mode = argv[3];
  if (pht_serving_init(argv[1]) != 0) {
    std::printf("init_error: %s\n", pht_predictor_last_error());
    return 0;
  }
  if (mode == "nocard") {
    void* e = pht_engine_create(argv[2], 2, 64, 4);
    std::printf("engine_null %d: %s\n", e == nullptr,
                pht_predictor_last_error());
    void* p = pht_predictor_create(argv[2]);
    std::printf("predictor_null %d: %s\n", p == nullptr,
                pht_predictor_last_error());
    return 0;
  }
  // the predictor's f32 path: token ids (3 + 5*i) % 128 as f32, 2 x 8
  void* p = pht_predictor_create(argv[2]);
  if (!p) {
    std::fprintf(stderr, "predictor: %s\n", pht_predictor_last_error());
    return 4;
  }
  std::vector<float> ids(16);
  for (int i = 0; i < 16; i++) ids[i] = (float)((3 + 5 * i) % 128);
  int64_t shape[2] = {2, 8};
  std::vector<float> logits(2 * 8 * 128);
  int64_t out_shape[4] = {0, 0, 0, 0};
  int64_t n = pht_predictor_run_f32(p, ids.data(), shape, 2, logits.data(),
                                    (int64_t)logits.size(), out_shape, 4);
  if (n < 0) {
    std::fprintf(stderr, "run: %s\n", pht_predictor_last_error());
    return 5;
  }
  std::printf("pred_shape: %lld %lld %lld\n", (long long)out_shape[0],
              (long long)out_shape[1], (long long)out_shape[2]);
  std::printf("pred_logits:");
  for (int64_t i = 0; i < n; i++) std::printf(" %.9g", logits[i]);
  std::printf("\n");
  int64_t small = pht_predictor_run_f32(p, ids.data(), shape, 2,
                                        logits.data(), 16, out_shape, 4);
  std::printf("pred_small %lld: %s\n", (long long)small,
              pht_predictor_last_error());
  int64_t bad = pht_predictor_run_f32(nullptr, ids.data(), shape, 2,
                                      logits.data(), 16, out_shape, 4);
  std::printf("pred_bad %lld: %s\n", (long long)bad,
              pht_predictor_last_error());
  pht_predictor_destroy(p);

  void* eng = pht_engine_create(argv[2], 4, 64, 4);
  if (!eng) {
    std::fprintf(stderr, "engine: %s\n", pht_predictor_last_error());
    return 6;
  }
  std::vector<int32_t> out(64);
  std::vector<int32_t> single = {11, 22, 33, 44, 55, 66};
  int64_t m = pht_engine_generate(eng, single.data(), 6, 6, out.data(), 64,
                                  300.0);
  if (m < 0) {
    std::fprintf(stderr, "single: %s\n", pht_predictor_last_error());
    return 7;
  }
  print_tokens("single", out.data(), m);
  // client k: tokens 7k+1, 7k+2, ... of length 5+k; client 0 waits with
  // timeout_s = 0 (forever)
  std::vector<std::vector<int32_t>> outs(4, std::vector<int32_t>(64));
  std::vector<int64_t> ns(4, 0);
  std::vector<std::thread> threads;
  for (int k = 0; k < 4; k++) {
    threads.emplace_back([&, k] {
      std::vector<int32_t> prompt;
      for (int i = 0; i < 5 + k; i++) prompt.push_back(7 * k + 1 + i);
      ns[k] = pht_engine_generate(eng, prompt.data(),
                                  (int32_t)prompt.size(), 6, outs[k].data(),
                                  64, k == 0 ? 0.0 : 300.0);
    });
  }
  for (auto& t : threads) t.join();
  for (int k = 0; k < 4; k++) {
    if (ns[k] < 0) {
      std::fprintf(stderr, "client %d: %s\n", k, pht_predictor_last_error());
      return 8;
    }
    std::string tag = "client " + std::to_string(k);
    print_tokens(tag.c_str(), outs[k].data(), ns[k]);
  }
  int64_t s = pht_engine_generate(eng, single.data(), 6, 6, out.data(), 3,
                                  300.0);
  std::printf("gen_small %lld: %s\n", (long long)s,
              pht_predictor_last_error());
  int64_t b = pht_engine_generate(nullptr, single.data(), 6, 6, out.data(),
                                  64, 300.0);
  std::printf("gen_bad %lld: %s\n", (long long)b, pht_predictor_last_error());
  std::string missing = std::string(argv[2]) + ".missing";
  void* e2 = pht_engine_create(missing.c_str(), 2, 64, 4);
  std::printf("engine_missing %d: %s\n", e2 == nullptr,
              pht_predictor_last_error());
  void* p2 = pht_predictor_create(missing.c_str());
  std::printf("predictor_missing %d: %s\n", p2 == nullptr,
              pht_predictor_last_error());
  pht_engine_destroy(eng);
  return 0;
}
"""


def _ids():
    return ((3 + 5 * np.arange(16)) % 128).astype(np.int32).reshape(2, 8)


def _client_prompts():
    return [np.arange(7 * k + 1, 7 * k + 6 + k, dtype=np.int32)
            for k in range(4)]


@pytest.fixture(scope="module")
def native_run(tmp_path_factory):
    """Build the shim and the client, save the JAX artifact, run the client
    (full mode under PHT_SERVING_PLATFORM=cpu, nocard without it, and an
    unknown platform), and the JAX references."""
    tmp = tmp_path_factory.mktemp("native")
    shim = native.build_serving_shim()
    src = tmp / "client.cc"
    src.write_text(CLIENT_CC)
    client = str(tmp / "client")
    subprocess.run(["g++", "-O2", "-std=c++17", str(src),
                    *native.client_link_flags(shim), "-o", client],
                   check=True, capture_output=True, text=True)
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    mdir = str(tmp / "gpt")
    save_for_serving(jm, mdir)
    runs = {}
    for mode, plat in (("full", "cpu"), ("nocard", None),
                       ("badplat", "tpu")):
        env = native.client_env(plat)
        if plat is None:
            env.pop("PHT_SERVING_PLATFORM", None)
            # no card here; hide one where there is
            env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run([client, ROOT, mdir, mode],
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert res.returncode == 0, (mode, res.returncode,
                                     res.stderr[-3000:])
        runs[mode] = dict(ln.split(": ", 1) if ": " in ln
                          else (ln.rstrip(":"), "")
                          for ln in res.stdout.splitlines())
    # the JAX references: the engine's greedy tokens and the predictor
    eng = JEngine(jm, auto_run=False, max_slots=4, max_len=64, chunk=4)
    prompts = [np.asarray([11, 22, 33, 44, 55, 66], np.int32)] + \
        _client_prompts()
    reqs = [eng.submit(p, NEW) for p in prompts]
    eng.run_until_idle()
    refs = [r.result() for r in reqs]
    eng.shutdown(timeout=5)
    cfg = jinf.Config(mdir)
    cfg.disable_gpu()
    (logits,) = jinf.create_predictor(cfg).run([_ids()])
    return runs, refs, np.asarray(logits, np.float32)


def _toks(s):
    return np.asarray([int(t) for t in s.split()], np.int32)


def test_single_request_equals_jax_engine(native_run):
    runs, refs, _ = native_run
    np.testing.assert_array_equal(_toks(runs["full"]["single"]), refs[0])


def test_concurrent_generation_equals_jax_engine(native_run):
    runs, refs, _ = native_run
    for k in range(4):
        np.testing.assert_array_equal(_toks(runs["full"][f"client {k}"]),
                                      refs[1 + k])


def test_predictor_abi_logits_match_jax_predictor(native_run):
    runs, _, want = native_run
    assert runs["full"]["pred_shape"] == "2 8 128"
    got = np.asarray([float(v) for v in
                      runs["full"]["pred_logits"].split()], np.float32)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5,
                               atol=1e-5)


def test_error_paths_return_their_strings(native_run):
    full = native_run[0]["full"]
    assert full["pred_small -2"] == "output buffer too small"
    assert full["pred_bad -3"] == "bad predictor handle"
    assert full["gen_small -2"] == "output buffer too small"
    assert full["gen_bad -3"] == "bad engine handle"
    assert "no serving artifact" in full["predictor_missing 1"]
    assert full["engine_missing 1"]          # load_for_serving's error


def test_without_platform_there_is_no_cpu_fallback(native_run):
    nocard = native_run[0]["nocard"]
    assert "no CUDA device" in nocard["engine_null 1"]
    assert "no CUDA device" in nocard["predictor_null 1"]
    bad = native_run[0]["badplat"]
    assert bad["init_error"] == \
        "failed to import paddle_hackathon_tpu_torch.inference"


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|paddle_hackathon_tpu)\b",
                     re.M)


def test_shim_and_port_import_nothing_of_jax():
    src = open(os.path.join(PORT, "native", "serving.cc")).read()
    # every module the embedded Python imports
    mods = set(re.findall(r'"\s*(?:import|from)\s+([\w.]+)', src))
    assert mods == {"sys", "numpy", "paddle_hackathon_tpu_torch.inference"}
    assert "jax" not in src
    hits = []
    for path in [os.path.join(ROOT, "chip_smoke.py")] + [
            os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
            if f.endswith(".py")]:
        with open(path) as f:
            hits += [f"{path}: {m.group(0).strip()}"
                     for m in _IMPORT.finditer(f.read())]
    assert hits == []
