// Native inference serving shim: the port's counterpart of the JAX
// package's native/serving.cc, with the same C functions, signatures and
// threading contract.
//
// The counterpart of the reference's C++ predictor stack
// (paddle/fluid/inference/api/analysis_predictor.h:95 and the C API in
// paddle/fluid/inference/capi_exp): a C ABI a C++ serving process links
// against to load a saved model artifact and run inference with NO Python
// in its own source. The runtime embeds CPython, and behind it PyTorch and
// the port's CUDA kernels (paddle_hackathon_tpu_torch.inference); the
// embedded code imports nothing else of this repository.
//
// Device: the engine and the predictor run on the CUDA card, or fail with
// an error string when there is none. PHT_SERVING_PLATFORM=cpu in the
// environment asks for the CPU (the port's plain PyTorch path).
//
// Threading: init and create serialize on one internal mutex and run
// under the GIL. One process = one interpreter; predictors are
// independent handles (Predictor.clone() semantics apply server-side).
//
// API:
//   pht_serving_init(repo_dir)                    -> 0/-1 (idempotent)
//   pht_predictor_create(model_path)              -> handle | NULL
//   pht_predictor_run_f32(h, in, shape, ndim,
//                         out, out_cap, out_shape, out_ndim_cap)
//                                                 -> out elem count | <0
//   pht_predictor_last_error()                    -> static error string
//   pht_predictor_destroy(h)
// The port's predictor serves save_for_serving GPT artifacts, whose one
// feed is input_ids: `in` holds token ids as whole f32 values (exact up
// to 2^24) and reaches the model as int32; `out` receives the f32 logits.
//
// Generation serving (continuous batching — the DistModel-style
// persistent runtime, fleet_executor/dist_model.cc):
//   pht_engine_create(model_dir, max_slots, max_len, chunk) -> handle
//   pht_engine_generate(h, prompt, prompt_len, max_new,
//                       out, out_cap, timeout_s)  -> total tokens | <0
//   pht_engine_destroy(h)
// pht_engine_generate is CONCURRENT: it does not take the module mutex,
// and the embedded engine batches requests from many caller threads into
// the same device ticks. The GIL is released while a request waits
// (threading.Event.wait), so callers block without serializing.
// timeout_s <= 0 means wait forever (Event.wait(None)). A timed-out
// request is ABANDONED by the caller but not cancelled: it still runs to
// completion in the engine, occupying its slot and burning ticks until
// its token budget is spent — budget max_new accordingly.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#define PHT_API extern "C" __attribute__((visibility("default")))

namespace {

std::mutex g_mu;
bool g_inited = false;
// error slot: written under its own mutex (pht_engine_generate runs
// concurrently, outside g_mu); readers copy into a thread_local snapshot
// so the returned pointer is stable for the calling thread while the
// global keeps the cross-thread "last error anywhere" contract
std::mutex g_err_mu;
std::string g_err_store;
thread_local std::string g_err_snapshot;

void set_err(const std::string& msg) {
  std::lock_guard<std::mutex> e(g_err_mu);
  g_err_store = msg;
}

void set_err_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_err(msg);
}

struct NativePredictor {
  PyObject* predictor = nullptr;  // inference.predictor.Predictor
};

}  // namespace

PHT_API const char* pht_predictor_last_error() {
  std::lock_guard<std::mutex> e(g_err_mu);
  g_err_snapshot = g_err_store;
  return g_err_snapshot.c_str();
}

PHT_API int32_t pht_serving_init(const char* repo_dir) {
  std::lock_guard<std::mutex> g(g_mu);
  if (g_inited) return 0;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  // the path crosses as a Python OBJECT, never interpolated into source
  // (a quote sequence in the path would break — or inject into — the
  // generated code)
  {
    PyObject* main = PyImport_AddModule("__main__");
    PyObject* globals = PyModule_GetDict(main);
    PyObject* dir_obj = PyUnicode_FromString(repo_dir);
    if (!dir_obj) {  // e.g. non-UTF-8 bytes in the path
      PyErr_Clear();
      set_err("repo_dir is not valid UTF-8");
      PyGILState_Release(gil);
      if (we_initialized) PyEval_SaveThread();
      return -1;
    }
    PyDict_SetItemString(globals, "_pht_repo_dir", dir_obj);
    Py_DECREF(dir_obj);
  }
  std::string code =
      "import sys, os\n"
      "sys.path.insert(0, _pht_repo_dir)\n"
      "_plat = os.environ.get('PHT_SERVING_PLATFORM') or None\n"
      "if _plat not in (None, 'cpu', 'cuda', 'gpu'):\n"
      "    raise ValueError('PHT_SERVING_PLATFORM must be cpu, cuda or gpu, '\n"
      "                     'got %r' % _plat)\n"
      "_pht_device = 'cpu' if _plat == 'cpu' else None\n"
      "import paddle_hackathon_tpu_torch.inference as _pht_inf\n";
  int rc = PyRun_SimpleString(code.c_str());
  if (rc == 0) g_inited = true;
  else set_err("failed to import paddle_hackathon_tpu_torch.inference");
  PyGILState_Release(gil);
  if (we_initialized) {
    // Py_InitializeEx left this thread holding the GIL via its thread
    // state; release it or every OTHER thread's PyGILState_Ensure blocks
    // forever (serving processes dispatch on worker threads)
    PyEval_SaveThread();
  }
  return rc == 0 ? 0 : -1;
}

PHT_API void* pht_predictor_create(const char* model_path) {
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_inited) {
    set_err("pht_serving_init not called");
    return nullptr;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  NativePredictor* np = nullptr;
  PyObject* main = PyImport_AddModule("__main__");  // borrowed
  PyObject* globals = PyModule_GetDict(main);       // borrowed
  PyObject* path_obj = PyUnicode_FromString(model_path);
  if (!path_obj) {
    PyErr_Clear();
    set_err("model_path is not valid UTF-8");
    PyGILState_Release(gil);
    return nullptr;
  }
  PyDict_SetItemString(globals, "_pht_model_path", path_obj);
  Py_DECREF(path_obj);
  const char* code =
      "_pht_cfg = _pht_inf.Config(_pht_model_path)\n"
      "if _pht_device == 'cpu':\n"
      "    _pht_cfg.disable_gpu()\n"
      "_pht_pred = _pht_inf.create_predictor(_pht_cfg)\n";
  PyObject* res = PyRun_String(code, Py_file_input, globals, globals);
  if (res) {
    Py_DECREF(res);
    PyObject* pred = PyDict_GetItemString(globals, "_pht_pred");  // borrowed
    if (pred) {
      np = new NativePredictor();
      Py_INCREF(pred);
      np->predictor = pred;
      PyDict_DelItemString(globals, "_pht_pred");
      PyDict_DelItemString(globals, "_pht_cfg");
    } else {
      set_err("predictor object missing after create");
    }
  } else {
    set_err_from_python();
  }
  PyGILState_Release(gil);
  return np;
}

// Single-input / single-output f32 path (multi-io callers hold one
// predictor per signature): the f32 token ids in, the f32 logits out.
// Returns the number of output elements written, or <0: -1 python error,
// -2 output buffer too small, -3 bad handle.
PHT_API int64_t pht_predictor_run_f32(void* h, const float* in,
                                      const int64_t* shape, int32_t ndim,
                                      float* out, int64_t out_cap,
                                      int64_t* out_shape,
                                      int32_t out_ndim_cap) {
  std::lock_guard<std::mutex> g(g_mu);
  auto* np = static_cast<NativePredictor*>(h);
  if (!np || !np->predictor) {
    set_err("bad predictor handle");
    return -3;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int64_t ret = -1;

  // build a numpy array from the caller's buffer without numpy's C API:
  // go through python (np.frombuffer on a memoryview) — slow-path-free
  // for the actual inference, which dominates
  int64_t n_in = 1;
  for (int32_t i = 0; i < ndim; i++) n_in *= shape[i];
  PyObject* mem = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(in)),
      n_in * static_cast<int64_t>(sizeof(float)), PyBUF_READ);
  PyObject* shape_t = PyTuple_New(ndim);
  for (int32_t i = 0; i < ndim; i++)
    PyTuple_SET_ITEM(shape_t, i, PyLong_FromLongLong(shape[i]));

  PyObject* main = PyImport_AddModule("__main__");
  PyObject* globals = PyModule_GetDict(main);
  PyDict_SetItemString(globals, "_pht_mem", mem);
  PyDict_SetItemString(globals, "_pht_shape", shape_t);
  PyDict_SetItemString(globals, "_pht_p", np->predictor);
  PyObject* res = PyRun_String(
      "import numpy as _np\n"
      "_x = _np.frombuffer(_pht_mem, dtype=_np.float32)"
      ".reshape(tuple(_pht_shape))\n"
      "if not _np.array_equal(_x, _np.rint(_x)):\n"
      "    raise ValueError('input_ids must be whole numbers')\n"
      "_x = _x.astype(_np.int32)\n"
      "_outs = _pht_p.run([_x])\n"
      "_y = _np.ascontiguousarray(_np.asarray(_outs[0], _np.float32))\n",
      Py_file_input, globals, globals);
  if (res) {
    Py_DECREF(res);
    PyObject* y = PyDict_GetItemString(globals, "_y");  // borrowed
    PyObject* buf_obj =
        y ? PyObject_CallMethod(y, "tobytes", nullptr) : nullptr;
    PyObject* yshape = y ? PyObject_GetAttrString(y, "shape") : nullptr;
    if (buf_obj && yshape) {
      Py_ssize_t nbytes = PyBytes_Size(buf_obj);
      int64_t n_out = nbytes / static_cast<int64_t>(sizeof(float));
      int32_t yndim = static_cast<int32_t>(PyTuple_Size(yshape));
      if (n_out > out_cap || yndim > out_ndim_cap) {
        set_err("output buffer too small");
        ret = -2;
      } else {
        std::memcpy(out, PyBytes_AsString(buf_obj), nbytes);
        for (int32_t i = 0; i < yndim; i++)
          out_shape[i] = PyLong_AsLongLong(PyTuple_GetItem(yshape, i));
        for (int32_t i = yndim; i < out_ndim_cap; i++) out_shape[i] = 0;
        ret = n_out;
      }
    } else {
      set_err_from_python();
    }
    Py_XDECREF(buf_obj);
    Py_XDECREF(yshape);
  } else {
    set_err_from_python();
  }
  for (const char* k : {"_pht_mem", "_pht_shape", "_pht_p", "_x", "_outs",
                        "_y"})
    if (PyDict_GetItemString(globals, k))  // missing after an error is fine
      PyDict_DelItemString(globals, k);
  PyErr_Clear();  // never leak a pending exception across the ABI
  Py_DECREF(mem);
  Py_DECREF(shape_t);
  PyGILState_Release(gil);
  return ret;
}

PHT_API void pht_predictor_destroy(void* h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto* np = static_cast<NativePredictor*>(h);
  if (!np) return;
  if (Py_IsInitialized()) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(np->predictor);
    PyGILState_Release(gil);
  }
  delete np;
}

namespace {
struct NativeEngine {
  PyObject* engine = nullptr;  // inference.serving.ServingEngine
};
}  // namespace

PHT_API void* pht_engine_create(const char* model_dir, int32_t max_slots,
                                int32_t max_len, int32_t chunk) {
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_inited) {
    set_err("pht_serving_init not called");
    return nullptr;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  NativeEngine* ne = nullptr;
  PyObject* main = PyImport_AddModule("__main__");  // borrowed
  PyObject* globals = PyModule_GetDict(main);       // borrowed
  PyObject* dir_obj = PyUnicode_FromString(model_dir);
  if (!dir_obj) {
    PyErr_Clear();
    set_err("model_dir is not valid UTF-8");
    PyGILState_Release(gil);
    return nullptr;
  }
  PyDict_SetItemString(globals, "_pht_model_dir", dir_obj);
  Py_DECREF(dir_obj);
  std::string code =
      "_pht_eng = _pht_inf.serving.ServingEngine(\n"
      "    _pht_inf.serving.load_for_serving(_pht_model_dir,\n"
      "                                      device=_pht_device),\n"
      "    max_slots=" + std::to_string(max_slots) +
      ", max_len=" + std::to_string(max_len) +
      ", chunk=" + std::to_string(chunk) + ")\n";
  PyObject* res = PyRun_String(code.c_str(), Py_file_input, globals, globals);
  if (res) {
    Py_DECREF(res);
    PyObject* eng = PyDict_GetItemString(globals, "_pht_eng");  // borrowed
    if (eng) {
      ne = new NativeEngine();
      Py_INCREF(eng);
      ne->engine = eng;
      PyDict_DelItemString(globals, "_pht_eng");
    } else {
      set_err("engine object missing after create");
    }
  } else {
    set_err_from_python();
  }
  PyGILState_Release(gil);
  return ne;
}

// Blocking generation: returns the FULL sequence (prompt + generated)
// token count written to `out`, or <0: -1 python error/timeout, -2 output
// buffer too small, -3 bad handle. Deliberately NOT under g_mu — requests
// from concurrent caller threads batch into the same engine ticks.
PHT_API int64_t pht_engine_generate(void* h, const int32_t* prompt,
                                    int32_t prompt_len, int32_t max_new,
                                    int32_t* out, int64_t out_cap,
                                    double timeout_s) {
  auto* ne = static_cast<NativeEngine*>(h);
  if (!ne || !ne->engine) {
    set_err("bad engine handle");
    return -3;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int64_t ret = -1;
  PyObject* lst = PyList_New(prompt_len);
  for (int32_t i = 0; i < prompt_len; i++)
    PyList_SET_ITEM(lst, i, PyLong_FromLong(prompt[i]));
  // generate(prompt, max_new_tokens, timeout): Event.wait inside releases
  // the GIL, so the engine's tick thread and other callers keep running.
  // timeout_s <= 0 maps to timeout=None (wait forever) — a raw 0.0 would
  // reach Event.wait(0) and time out immediately.
  PyObject* res =
      timeout_s <= 0.0
          ? PyObject_CallMethod(ne->engine, "generate", "(OiO)", lst,
                                (int)max_new, Py_None)
          : PyObject_CallMethod(ne->engine, "generate", "(Oid)", lst,
                                (int)max_new, timeout_s);
  if (res) {
    PyObject* as_list = PyObject_CallMethod(res, "tolist", nullptr);
    if (as_list) {
      Py_ssize_t n = PyList_Size(as_list);
      if (n > out_cap) {
        set_err("output buffer too small");
        ret = -2;
      } else {
        for (Py_ssize_t i = 0; i < n; i++)
          out[i] = (int32_t)PyLong_AsLong(PyList_GetItem(as_list, i));
        ret = (int64_t)n;
      }
      Py_DECREF(as_list);
    } else {
      set_err_from_python();
    }
    Py_DECREF(res);
  } else {
    set_err_from_python();
  }
  Py_DECREF(lst);
  PyErr_Clear();
  PyGILState_Release(gil);
  return ret;
}

PHT_API void pht_engine_destroy(void* h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto* ne = static_cast<NativeEngine*>(h);
  if (!ne) return;
  if (Py_IsInitialized()) {
    PyGILState_STATE gil = PyGILState_Ensure();
    // drain the background loop before dropping the last reference so a
    // daemon tick thread isn't left running against a freed engine
    PyObject* r = PyObject_CallMethod(ne->engine, "shutdown", "(d)", 60.0);
    if (!r) PyErr_Clear();
    Py_XDECREF(r);
    Py_XDECREF(ne->engine);
    PyGILState_Release(gil);
  }
  delete ne;
}
