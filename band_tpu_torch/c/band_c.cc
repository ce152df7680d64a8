// band-tpu-torch C ABI implementation (a port of band_tpu/c/band_c.cc).
//
// Embeds a CPython interpreter and forwards every call to the thin glue
// module band_tpu_torch.c._embed; the C++ side only marshals raw buffers
// and opaque handles.  Role-equivalent to the reference's band/c/c_api.cc +
// c_api_internal.cc (which wrap the C++ engine the same way this wraps
// the Python engine).
//
// Build: python -m band_tpu_torch.c.build  (emits libband_tpu_torch_c.so
// into band_tpu_torch/_build/; see build.py for flags).

#include "band_c.h"

#define PY_SSIZE_T_CLEAN  // '#' length args are Py_ssize_t, not int
#include <Python.h>

#include <cstdarg>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string t_last_error;

void set_error(const std::string& msg) { t_last_error = msg; }

// Must hold the GIL.
void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

std::once_flag g_init_once;

void ensure_python() {
  std::call_once(g_init_once, [] {
    if (Py_IsInitialized()) return;  // loaded inside a Python process
    Py_InitializeEx(0);
    PyEval_SaveThread();  // release the GIL for PyGILState_Ensure users
  });
}

class Gil {
 public:
  Gil() {
    ensure_python();
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }
  Gil(const Gil&) = delete;
  Gil& operator=(const Gil&) = delete;

 private:
  PyGILState_STATE state_;
};

// Must hold the GIL.
PyObject* embed() {
  static PyObject* mod = nullptr;  // leaked singleton, owned ref
  if (mod == nullptr) {
    mod = PyImport_ImportModule("band_tpu_torch.c._embed");
    if (mod == nullptr) set_error_from_python();
  }
  return mod;
}

}  // namespace

struct BandConfigBuilder {
  PyObject* dict;  // owned
};

struct BandConfig {
  PyObject* cfg;  // owned RuntimeConfig
};

struct BandModel {
  PyObject* model = nullptr;  // owned band_tpu_torch Model (set by Add*)
  int model_id = -1;          // set by BandEngineRegisterModel
};

struct BandEngine {
  PyObject* engine;  // owned
};

struct BandTensor {
  std::vector<int> dims;
  std::string dtype;  // numpy dtype name
  std::string name;
  std::vector<unsigned char> data;
  // affine quantization (empty scales = unquantized)
  std::vector<float> q_scales;
  std::vector<int> q_zero_points;
  BandAffineQuantization q_view = {0, nullptr, nullptr, 0};
};

struct BandBuffer {
  PyObject* buf = nullptr;  // owned band_tpu_torch.buffer.Buffer (set by Set*)
};

struct BandImageProcessorBuilder {
  PyObject* ops;  // owned list of (field:int, (args...)) tuples
};

struct BandImageProcessor {
  PyObject* ops;  // owned snapshot of the builder's op list
};

namespace {

// Must hold the GIL. Returns new ref or nullptr (error recorded).
PyObject* call_embed(const char* fn, PyObject* args /* stolen */) {
  PyObject* mod = embed();
  if (mod == nullptr) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (f == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (out == nullptr) set_error_from_python();
  return out;
}

// Must hold the GIL. New ref: [(bytes, dtype, dims), ...]
PyObject* raw_tensor_list(BandTensor** tensors, size_t n) {
  PyObject* list = PyList_New((Py_ssize_t)n);
  for (size_t i = 0; i < n; ++i) {
    BandTensor* t = tensors[i];
    PyObject* dims = PyList_New((Py_ssize_t)t->dims.size());
    for (size_t d = 0; d < t->dims.size(); ++d) {
      PyList_SET_ITEM(dims, (Py_ssize_t)d, PyLong_FromLong(t->dims[d]));
    }
    PyObject* triple = Py_BuildValue(
        "(y#sN)", reinterpret_cast<const char*>(t->data.data()),
        (Py_ssize_t)t->data.size(), t->dtype.c_str(), dims);
    PyList_SET_ITEM(list, (Py_ssize_t)i, triple);
  }
  return list;
}

// Must hold the GIL. Copies [(bytes, dtype, dims)] into the given
// output tensors (up to num_outputs). Returns false on mismatch.
bool copy_outputs(PyObject* raw_list, BandTensor** outputs,
                  size_t num_outputs) {
  if (outputs == nullptr || num_outputs == 0) return true;
  Py_ssize_t n = PyList_Size(raw_list);
  if ((size_t)n < num_outputs) {
    set_error("fewer outputs than output tensors");
    return false;
  }
  for (size_t i = 0; i < num_outputs; ++i) {
    PyObject* triple = PyList_GetItem(raw_list, (Py_ssize_t)i);
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyObject* bytes = PyTuple_GetItem(triple, 0);
    if (PyBytes_AsStringAndSize(bytes, &buf, &len) != 0) {
      set_error_from_python();
      return false;
    }
    BandTensor* t = outputs[i];
    if ((size_t)len != t->data.size()) {
      set_error("output size mismatch at index " + std::to_string(i));
      return false;
    }
    std::memcpy(t->data.data(), buf, (size_t)len);
  }
  return true;
}

// Must hold the GIL. New ref RequestOption.
PyObject* py_option(const BandRequestOption& o) {
  return call_embed("make_option",
                    Py_BuildValue("(iiif)", o.target_worker,
                                  o.require_callback, o.slo_us, o.slo_scale));
}

BandTensor* create_io_tensor(BandEngine* engine, BandModel* model,
                             size_t index, const char* which) {
  if (engine == nullptr || model == nullptr || model->model_id < 0) {
    set_error("model is not registered with this engine");
    return nullptr;
  }
  Gil gil;
  PyObject* specs = call_embed(
      "tensor_specs",
      Py_BuildValue("(Ois)", engine->engine, model->model_id, which));
  if (specs == nullptr) return nullptr;
  BandTensor* out = nullptr;
  if ((Py_ssize_t)index < PyList_Size(specs)) {
    PyObject* spec = PyList_GetItem(specs, (Py_ssize_t)index);
    PyObject* dims = PyTuple_GetItem(spec, 0);
    const char* dtype = PyUnicode_AsUTF8(PyTuple_GetItem(spec, 1));
    const char* name = PyUnicode_AsUTF8(PyTuple_GetItem(spec, 2));
    long nbytes = PyLong_AsLong(PyTuple_GetItem(spec, 3));
    PyObject* quant = PyTuple_GetItem(spec, 4);
    out = new BandTensor();
    for (Py_ssize_t d = 0; d < PyList_Size(dims); ++d) {
      out->dims.push_back((int)PyLong_AsLong(PyList_GetItem(dims, d)));
    }
    out->dtype = dtype != nullptr ? dtype : "";
    out->name = name != nullptr ? name : "";
    out->data.assign((size_t)nbytes, 0);
    if (quant != nullptr && quant != Py_None) {
      PyObject* scales = PyTuple_GetItem(quant, 0);
      PyObject* zps = PyTuple_GetItem(quant, 1);
      for (Py_ssize_t i = 0; i < PyList_Size(scales); ++i) {
        out->q_scales.push_back(
            (float)PyFloat_AsDouble(PyList_GetItem(scales, i)));
        out->q_zero_points.push_back(
            (int)PyLong_AsLong(PyList_GetItem(zps, i)));
      }
      out->q_view = {(int)out->q_scales.size(), out->q_scales.data(),
                     out->q_zero_points.data(),
                     (int)PyLong_AsLong(PyTuple_GetItem(quant, 2))};
    }
  } else {
    set_error("tensor index out of range");
  }
  Py_DECREF(specs);
  return out;
}

struct CbCtx {
  void (*fn)(void*, int, BandStatus);
  void* user_data;
};

struct LogCbCtx {
  void (*fn)(BandLogSeverity, const char*);
};

PyObject* log_trampoline(PyObject* self, PyObject* args) {
  LogCbCtx* ctx =
      static_cast<LogCbCtx*>(PyCapsule_GetPointer(self, "band_tpu_torch.logcb"));
  int severity = 0;
  const char* msg = nullptr;
  if (!PyArg_ParseTuple(args, "is", &severity, &msg)) return nullptr;
  if (ctx != nullptr && ctx->fn != nullptr) {
    Py_BEGIN_ALLOW_THREADS
    ctx->fn((BandLogSeverity)severity, msg);
    Py_END_ALLOW_THREADS
  }
  Py_RETURN_NONE;
}

PyMethodDef g_log_cb_def = {"_band_c_log", log_trampoline, METH_VARARGS,
                            nullptr};

void log_capsule_destructor(PyObject* cap) {
  delete static_cast<LogCbCtx*>(PyCapsule_GetPointer(cap, "band_tpu_torch.logcb"));
}

PyObject* cb_trampoline(PyObject* self, PyObject* args) {
  CbCtx* ctx =
      static_cast<CbCtx*>(PyCapsule_GetPointer(self, "band_tpu_torch.cb"));
  int job_id = 0, status = 0;
  if (!PyArg_ParseTuple(args, "ii", &job_id, &status)) return nullptr;
  if (ctx != nullptr && ctx->fn != nullptr) {
    // Release the GIL around user code: it may call back into this API.
    Py_BEGIN_ALLOW_THREADS
    ctx->fn(ctx->user_data, job_id, (BandStatus)status);
    Py_END_ALLOW_THREADS
  }
  Py_RETURN_NONE;
}

PyMethodDef g_cb_def = {"_band_c_on_end", cb_trampoline, METH_VARARGS,
                        nullptr};

void cb_capsule_destructor(PyObject* cap) {
  delete static_cast<CbCtx*>(PyCapsule_GetPointer(cap, "band_tpu_torch.cb"));
}

}  // namespace

extern "C" {

const char* BandGetLastError(void) { return t_last_error.c_str(); }

/* -- logging ------------------------------------------------------------ */

void BandSetLogSeverity(BandLogSeverity severity) {
  Gil gil;
  PyObject* r =
      call_embed("set_log_severity", Py_BuildValue("(i)", (int)severity));
  Py_XDECREF(r);
}

int BandSetLogReporter(void (*reporter)(BandLogSeverity, const char*)) {
  if (reporter == nullptr) return -1;
  Gil gil;
  LogCbCtx* ctx = new LogCbCtx{reporter};
  PyObject* cap = PyCapsule_New(ctx, "band_tpu_torch.logcb", log_capsule_destructor);
  if (cap == nullptr) {
    delete ctx;
    set_error_from_python();
    return -1;
  }
  PyObject* fn = PyCFunction_New(&g_log_cb_def, cap);
  Py_DECREF(cap);
  if (fn == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = call_embed("set_log_reporter", Py_BuildValue("(N)", fn));
  if (r == nullptr) return -1;
  int h = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return h;
}

void BandUnsetLogReporter(int handle) {
  Gil gil;
  PyObject* r =
      call_embed("unset_log_reporter", Py_BuildValue("(i)", handle));
  Py_XDECREF(r);
}

/* -- config -------------------------------------------------------------- */

BandConfigBuilder* BandConfigBuilderCreate(void) {
  Gil gil;
  PyObject* d = PyDict_New();
  if (d == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  return new BandConfigBuilder{d};
}

void BandConfigBuilderDelete(BandConfigBuilder* b) {
  if (b == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(b->dict);
  }
  delete b;
}

BandStatus BandAddConfigJson(BandConfigBuilder* b, const char* json_text) {
  if (b == nullptr || json_text == nullptr) return kBandError;
  Gil gil;
  PyObject* r = call_embed("merge_json",
                           Py_BuildValue("(Os)", b->dict, json_text));
  if (r == nullptr) return kBandError;
  Py_DECREF(r);
  return kBandOk;
}

BandStatus BandAddConfigKV(BandConfigBuilder* b, const char* key,
                           const char* value) {
  if (b == nullptr || key == nullptr || value == nullptr) return kBandError;
  Gil gil;
  PyObject* r =
      call_embed("set_key", Py_BuildValue("(Oss)", b->dict, key, value));
  if (r == nullptr) return kBandError;
  Py_DECREF(r);
  return kBandOk;
}

BandConfig* BandConfigCreate(BandConfigBuilder* b) {
  if (b == nullptr) return nullptr;
  Gil gil;
  PyObject* cfg = call_embed("build_config", Py_BuildValue("(O)", b->dict));
  if (cfg == nullptr) return nullptr;
  return new BandConfig{cfg};
}

BandConfig* BandConfigCreateFromFile(const char* json_path) {
  if (json_path == nullptr) return nullptr;
  Gil gil;
  PyObject* cfg =
      call_embed("build_config_from_file", Py_BuildValue("(s)", json_path));
  if (cfg == nullptr) return nullptr;
  return new BandConfig{cfg};
}

void BandConfigDelete(BandConfig* config) {
  if (config == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(config->cfg);
  }
  delete config;
}

/* -- model --------------------------------------------------------------- */

BandModel* BandModelCreate(void) { return new BandModel(); }

void BandModelDelete(BandModel* model) {
  if (model == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(model->model);
  }
  delete model;
}

BandStatus BandModelAddFromFile(BandModel* model, const char* model_path) {
  if (model == nullptr || model_path == nullptr) return kBandError;
  Gil gil;
  PyObject* m =
      call_embed("model_from_path", Py_BuildValue("(s)", model_path));
  if (m == nullptr) return kBandError;
  Py_XDECREF(model->model);
  model->model = m;
  return kBandOk;
}

BandStatus BandModelAddFromBuffer(BandModel* model, const void* model_data,
                                  size_t model_size) {
  if (model == nullptr || model_data == nullptr) return kBandError;
  Gil gil;
  PyObject* m = call_embed(
      "model_from_buffer",
      Py_BuildValue("(y#)", reinterpret_cast<const char*>(model_data),
                    (Py_ssize_t)model_size));
  if (m == nullptr) return kBandError;
  Py_XDECREF(model->model);
  model->model = m;
  return kBandOk;
}

/* -- tensor ---------------------------------------------------------------- */

void BandTensorDelete(BandTensor* tensor) { delete tensor; }

BandDataType BandTensorGetType(BandTensor* tensor) {
  if (tensor == nullptr) return kBandNoType;
  Gil gil;
  PyObject* r =
      call_embed("dtype_to_c", Py_BuildValue("(s)", tensor->dtype.c_str()));
  if (r == nullptr) return kBandNoType;
  BandDataType t = (BandDataType)PyLong_AsLong(r);
  Py_DECREF(r);
  return t;
}

void* BandTensorGetData(BandTensor* tensor) {
  return tensor == nullptr ? nullptr : tensor->data.data();
}

size_t BandTensorGetNumDims(BandTensor* tensor) {
  return tensor == nullptr ? 0 : tensor->dims.size();
}

const int* BandTensorGetDims(BandTensor* tensor) {
  return tensor == nullptr ? nullptr : tensor->dims.data();
}

size_t BandTensorGetBytes(BandTensor* tensor) {
  return tensor == nullptr ? 0 : tensor->data.size();
}

const char* BandTensorGetName(BandTensor* tensor) {
  return tensor == nullptr ? "" : tensor->name.c_str();
}

BandQuantizationType BandTensorGetQuantizationType(BandTensor* tensor) {
  return (tensor == nullptr || tensor->q_scales.empty())
             ? kBandNoQuantization
             : kBandAffineQuantization;
}

void* BandTensorGetQuantizationParams(BandTensor* tensor) {
  if (tensor == nullptr || tensor->q_scales.empty()) return nullptr;
  return &tensor->q_view;
}

/* -- request options ------------------------------------------------------- */

BandRequestOption BandRequestOptionGetDefault(void) {
  BandRequestOption o;
  o.target_worker = -1;
  o.require_callback = 1;
  o.slo_us = -1;
  o.slo_scale = -1.0f;
  return o;
}

/* -- engine ------------------------------------------------------------------ */

BandEngine* BandEngineCreate(BandConfig* config) {
  if (config == nullptr) return nullptr;
  Gil gil;
  PyObject* e =
      call_embed("engine_create", Py_BuildValue("(O)", config->cfg));
  if (e == nullptr) return nullptr;
  return new BandEngine{e};
}

BandEngine* BandEngineCreateWithDefaultConfig(void) {
  Gil gil;
  PyObject* e = call_embed("engine_create_default", nullptr);
  if (e == nullptr) return nullptr;
  return new BandEngine{e};
}

void BandEngineDelete(BandEngine* engine) {
  if (engine == nullptr) return;
  {
    Gil gil;
    PyObject* r =
        call_embed("engine_shutdown", Py_BuildValue("(O)", engine->engine));
    Py_XDECREF(r);
    Py_XDECREF(engine->engine);
  }
  delete engine;
}

BandStatus BandEngineRegisterModel(BandEngine* engine, BandModel* model) {
  if (engine == nullptr || model == nullptr || model->model == nullptr) {
    set_error("model has no content (call BandModelAddFromFile first)");
    return kBandError;
  }
  Gil gil;
  PyObject* r = call_embed(
      "register_model", Py_BuildValue("(OO)", engine->engine, model->model));
  if (r == nullptr) return kBandError;
  model->model_id = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return kBandOk;
}

BandStatus BandEngineUnregisterModel(BandEngine* engine, BandModel* model) {
  // extension beyond the reference C API (Engine::UnregisterModel is
  // C++-only there, engine.cc:291-316): hot-swap with safe drain
  if (engine == nullptr || model == nullptr || model->model_id < 0) {
    set_error("model is not registered");
    return kBandError;
  }
  Gil gil;
  PyObject* r = call_embed(
      "unregister_model",
      Py_BuildValue("(Oi)", engine->engine, model->model_id));
  if (r == nullptr) return kBandError;
  Py_DECREF(r);
  model->model_id = -1;
  return kBandOk;
}

int BandEngineGetNumInputTensors(BandEngine* engine, BandModel* model) {
  if (engine == nullptr || model == nullptr || model->model_id < 0) return -1;
  Gil gil;
  PyObject* specs = call_embed(
      "tensor_specs",
      Py_BuildValue("(Ois)", engine->engine, model->model_id, "in"));
  if (specs == nullptr) return -1;
  int n = (int)PyList_Size(specs);
  Py_DECREF(specs);
  return n;
}

int BandEngineGetNumOutputTensors(BandEngine* engine, BandModel* model) {
  if (engine == nullptr || model == nullptr || model->model_id < 0) return -1;
  Gil gil;
  PyObject* specs = call_embed(
      "tensor_specs",
      Py_BuildValue("(Ois)", engine->engine, model->model_id, "out"));
  if (specs == nullptr) return -1;
  int n = (int)PyList_Size(specs);
  Py_DECREF(specs);
  return n;
}

int BandEngineGetNumWorkers(BandEngine* engine) {
  if (engine == nullptr) return -1;
  Gil gil;
  PyObject* r =
      call_embed("num_workers", Py_BuildValue("(O)", engine->engine));
  if (r == nullptr) return -1;
  int n = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return n;
}

BandDeviceFlag BandEngineGetWorkerDevice(BandEngine* engine, int worker_id) {
  if (engine == nullptr) return kBandCpu;
  Gil gil;
  PyObject* r = call_embed(
      "worker_device", Py_BuildValue("(Oi)", engine->engine, worker_id));
  if (r == nullptr) return kBandCpu;
  BandDeviceFlag f = (BandDeviceFlag)PyLong_AsLong(r);
  Py_DECREF(r);
  return f;
}

BandTensor* BandEngineCreateInputTensor(BandEngine* engine, BandModel* model,
                                        size_t index) {
  return create_io_tensor(engine, model, index, "in");
}

BandTensor* BandEngineCreateOutputTensor(BandEngine* engine, BandModel* model,
                                         size_t index) {
  return create_io_tensor(engine, model, index, "out");
}

BandStatus BandEngineRequestSyncOptions(BandEngine* engine, BandModel* model,
                                        BandRequestOption options,
                                        BandTensor** input_tensors,
                                        BandTensor** output_tensors) {
  if (engine == nullptr || model == nullptr || model->model_id < 0) {
    set_error("model is not registered with this engine");
    return kBandError;
  }
  Gil gil;
  int n_in = BandEngineGetNumInputTensors(engine, model);
  int n_out = BandEngineGetNumOutputTensors(engine, model);
  if (n_in < 0 || n_out < 0) return kBandError;
  PyObject* opt = py_option(options);
  if (opt == nullptr) return kBandError;
  PyObject* raw = raw_tensor_list(input_tensors, (size_t)n_in);
  PyObject* r = call_embed(
      "request_sync",
      Py_BuildValue("(OiNN)", engine->engine, model->model_id, raw, opt));
  if (r == nullptr) return kBandError;
  BandStatus status = (BandStatus)PyLong_AsLong(PyTuple_GetItem(r, 0));
  if (status == kBandOk &&
      !copy_outputs(PyTuple_GetItem(r, 1), output_tensors, (size_t)n_out)) {
    status = kBandError;
  }
  Py_DECREF(r);
  return status;
}

BandStatus BandEngineRequestSync(BandEngine* engine, BandModel* model,
                                 BandTensor** input_tensors,
                                 BandTensor** output_tensors) {
  return BandEngineRequestSyncOptions(engine, model,
                                      BandRequestOptionGetDefault(),
                                      input_tensors, output_tensors);
}

BandRequestHandle BandEngineRequestAsyncOptions(BandEngine* engine,
                                                BandModel* model,
                                                BandRequestOption options,
                                                BandTensor** input_tensors) {
  if (engine == nullptr || model == nullptr || model->model_id < 0) {
    set_error("model is not registered with this engine");
    return -1;
  }
  Gil gil;
  int n_in = BandEngineGetNumInputTensors(engine, model);
  if (n_in < 0) return -1;
  PyObject* opt = py_option(options);
  if (opt == nullptr) return -1;
  PyObject* raw = raw_tensor_list(input_tensors, (size_t)n_in);
  PyObject* r = call_embed(
      "request_async",
      Py_BuildValue("(OiNN)", engine->engine, model->model_id, raw, opt));
  if (r == nullptr) return -1;
  int handle = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return handle;
}

BandRequestHandle BandEngineRequestAsync(BandEngine* engine, BandModel* model,
                                         BandTensor** input_tensors) {
  return BandEngineRequestAsyncOptions(
      engine, model, BandRequestOptionGetDefault(), input_tensors);
}

BandStatus BandEngineWait(BandEngine* engine, BandRequestHandle handle,
                          BandTensor** output_tensors, size_t num_outputs) {
  if (engine == nullptr || handle < 0) return kBandError;
  Gil gil;
  PyObject* r =
      call_embed("wait", Py_BuildValue("(Oi)", engine->engine, handle));
  if (r == nullptr) return kBandError;
  BandStatus status = (BandStatus)PyLong_AsLong(PyTuple_GetItem(r, 0));
  if (status == kBandOk &&
      !copy_outputs(PyTuple_GetItem(r, 1), output_tensors, num_outputs)) {
    status = kBandError;
  }
  Py_DECREF(r);
  return status;
}

int BandEngineSetOnEndRequest(BandEngine* engine,
                              void (*on_end_invoke)(void*, int, BandStatus),
                              void* user_data) {
  if (engine == nullptr || on_end_invoke == nullptr) return -1;
  Gil gil;
  CbCtx* ctx = new CbCtx{on_end_invoke, user_data};
  PyObject* cap = PyCapsule_New(ctx, "band_tpu_torch.cb", cb_capsule_destructor);
  if (cap == nullptr) {
    delete ctx;
    set_error_from_python();
    return -1;
  }
  PyObject* fn = PyCFunction_New(&g_cb_def, cap);
  Py_DECREF(cap);
  if (fn == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = call_embed(
      "set_on_end_request", Py_BuildValue("(ON)", engine->engine, fn));
  if (r == nullptr) return -1;
  int h = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return h;
}

BandStatus BandEngineUnsetOnEndRequest(BandEngine* engine,
                                       int callback_handle) {
  if (engine == nullptr || callback_handle < 0) return kBandError;
  Gil gil;
  PyObject* r = call_embed(
      "unset_on_end_request",
      Py_BuildValue("(Oi)", engine->engine, callback_handle));
  if (r == nullptr) return kBandError;
  bool removed = PyObject_IsTrue(r) == 1;
  Py_DECREF(r);
  if (!removed) set_error("unknown callback handle");
  return removed ? kBandOk : kBandError;
}

/* -- buffer + image processor --------------------------------------------- */

BandBuffer* BandBufferCreate(void) { return new BandBuffer(); }

void BandBufferDelete(BandBuffer* buffer) {
  if (buffer == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(buffer->buf);
  }
  delete buffer;
}

BandStatus BandBufferSetFromRawData(BandBuffer* buffer, const void* data,
                                    size_t width, size_t height,
                                    BandBufferFormat format) {
  if (buffer == nullptr || data == nullptr) {
    set_error("buffer or data is null");
    return kBandError;
  }
  // Total blob size by format (4:2:0 chroma planes round odd dims up).
  size_t wh = width * height;
  size_t cw = (width + 1) / 2, ch = (height + 1) / 2;
  size_t nbytes;
  switch (format) {
    case kBandGrayScale: nbytes = wh; break;
    case kBandRGB: nbytes = wh * 3; break;
    case kBandRGBA: nbytes = wh * 4; break;
    case kBandNV12:
    case kBandNV21: nbytes = wh + width * ch; break;
    case kBandYV12:
    case kBandYV21: nbytes = wh + 2 * cw * ch; break;
    default:
      set_error("unsupported raw buffer format");
      return kBandError;
  }
  Gil gil;
  PyObject* b = call_embed(
      "buffer_from_raw",
      Py_BuildValue("(y#nni)", reinterpret_cast<const char*>(data),
                    (Py_ssize_t)nbytes, (Py_ssize_t)width, (Py_ssize_t)height,
                    (int)format));
  if (b == nullptr) return kBandError;
  Py_XDECREF(buffer->buf);
  buffer->buf = b;
  return kBandOk;
}

BandStatus BandBufferSetFromYUVData(BandBuffer* buffer, const void* y_data,
                                    const void* u_data, const void* v_data,
                                    size_t width, size_t height,
                                    size_t row_stride_y, size_t row_stride_uv,
                                    size_t pixel_stride_uv,
                                    BandBufferFormat buffer_format) {
  bool semiplanar =
      buffer_format == kBandNV12 || buffer_format == kBandNV21;
  if (buffer == nullptr || y_data == nullptr || u_data == nullptr ||
      (!semiplanar && v_data == nullptr)) {
    set_error("buffer or YUV plane is null");
    return kBandError;
  }
  size_t ch = (height + 1) / 2;
  size_t cw = (width + 1) / 2;
  // copy only the true extent of each plane: camera buffers commonly
  // leave the LAST row unpadded (size = stride*(rows-1) + row_width),
  // so reading stride*rows would run past the caller's allocation
  size_t y_bytes = row_stride_y * (height - 1) + width;
  size_t uv_row = semiplanar ? width : ((cw - 1) * pixel_stride_uv + 1);
  size_t uv_bytes = row_stride_uv * (ch - 1) + uv_row;
  Gil gil;
  const char* v_ptr =
      v_data != nullptr ? reinterpret_cast<const char*>(v_data) : "";
  PyObject* b = call_embed(
      "buffer_from_yuv",
      Py_BuildValue("(y#y#y#nnnnni)", reinterpret_cast<const char*>(y_data),
                    (Py_ssize_t)y_bytes,
                    reinterpret_cast<const char*>(u_data),
                    (Py_ssize_t)uv_bytes, v_ptr,
                    (Py_ssize_t)(semiplanar ? 0 : uv_bytes),
                    (Py_ssize_t)width, (Py_ssize_t)height,
                    (Py_ssize_t)row_stride_y, (Py_ssize_t)row_stride_uv,
                    (Py_ssize_t)pixel_stride_uv, (int)buffer_format));
  if (b == nullptr) return kBandError;
  Py_XDECREF(buffer->buf);
  buffer->buf = b;
  return kBandOk;
}

BandImageProcessorBuilder* BandImageProcessorBuilderCreate(void) {
  Gil gil;
  PyObject* ops = PyList_New(0);
  if (ops == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  return new BandImageProcessorBuilder{ops};
}

void BandImageProcessorBuilderDelete(BandImageProcessorBuilder* builder) {
  if (builder == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(builder->ops);
  }
  delete builder;
}

BandStatus BandAddOperator(BandImageProcessorBuilder* builder,
                           BandImageProcessorBuilderField field, int count,
                           ...) {
  if (builder == nullptr) {
    set_error("builder is null");
    return kBandError;
  }
  // Expected arity + argument kind per field (reference:
  // band/c/c_api_buffer.cc BandAddOperator): ints everywhere except
  // BAND_NORMALIZE, which takes doubles.
  int expected;
  switch (field) {
    case BAND_CROP: expected = 4; break;
    case BAND_RESIZE: expected = 2; break;
    case BAND_ROTATE: expected = 1; break;
    case BAND_FLIP: expected = 2; break;
    case BAND_COLOR_SPACE_CONVERT: expected = 1; break;
    case BAND_NORMALIZE: expected = 2; break;
    case BAND_DATA_TYPE_CONVERT: expected = 0; break;
    default:
      set_error("unknown image processor field");
      return kBandError;
  }
  if (count != expected) {
    set_error("wrong argument count for image processor field");
    return kBandError;
  }
  Gil gil;
  PyObject* args = PyTuple_New(count);
  va_list vl;
  va_start(vl, count);
  for (int i = 0; i < count; ++i) {
    PyObject* v = field == BAND_NORMALIZE
                      ? PyFloat_FromDouble(va_arg(vl, double))
                      : PyLong_FromLong(va_arg(vl, int));
    PyTuple_SET_ITEM(args, i, v);
  }
  va_end(vl);
  PyObject* entry = Py_BuildValue("(iN)", (int)field, args);
  int rc = PyList_Append(builder->ops, entry);
  Py_DECREF(entry);
  if (rc != 0) {
    set_error_from_python();
    return kBandError;
  }
  return kBandOk;
}

BandImageProcessor* BandImageProcessorBuilderBuild(
    BandImageProcessorBuilder* builder) {
  if (builder == nullptr) {
    set_error("builder is null");
    return nullptr;
  }
  Gil gil;
  PyObject* snapshot = PySequence_List(builder->ops);
  if (snapshot == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  return new BandImageProcessor{snapshot};
}

BandStatus BandImageProcessorProcess(BandImageProcessor* image_processor,
                                     BandBuffer* buffer,
                                     BandTensor* target_tensor) {
  if (image_processor == nullptr || buffer == nullptr ||
      target_tensor == nullptr || buffer->buf == nullptr) {
    set_error("image processor, buffer (set?), or tensor is null");
    return kBandError;
  }
  Gil gil;
  PyObject* dims = PyList_New((Py_ssize_t)target_tensor->dims.size());
  for (size_t d = 0; d < target_tensor->dims.size(); ++d) {
    PyList_SET_ITEM(dims, (Py_ssize_t)d,
                    PyLong_FromLong(target_tensor->dims[d]));
  }
  PyObject* r = call_embed(
      "image_process",
      Py_BuildValue("(OONs)", image_processor->ops, buffer->buf, dims,
                    target_tensor->dtype.c_str()));
  if (r == nullptr) return kBandError;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  BandStatus status = kBandOk;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    set_error_from_python();
    status = kBandError;
  } else if ((size_t)len != target_tensor->data.size()) {
    set_error("image pipeline output size does not match target tensor");
    status = kBandError;
  } else {
    std::memcpy(target_tensor->data.data(), buf, (size_t)len);
  }
  Py_DECREF(r);
  return status;
}

void BandImageProcessorDelete(BandImageProcessor* processor) {
  if (processor == nullptr) return;
  {
    Gil gil;
    Py_XDECREF(processor->ops);
  }
  delete processor;
}

}  // extern "C"
