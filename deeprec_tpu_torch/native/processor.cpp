// Serving C ABI of the port: the symbol contract external RPC hosts code
// against (initialize / process / batch_process / batch_process_n /
// get_serving_model_info / free_buffer / shutdown_processor), the same as
// `deeprec_tpu/native/processor.cpp`, so a host built for either library
// can dlopen this one unchanged. An embedded CPython interpreter forwards
// payloads to deeprec_tpu_torch.serving.cabi, where the serving stack
// (validation, request coalescing onto the card, full and delta hot-swap
// polling, warmup) lives. Payloads may be the reference's protobuf wire
// format (a serialized PredictRequest -> PredictResponse) or JSON;
// cabi.py sniffs the format per request. The config JSON's "device" key
// picks the device ("cuda" unless "cpu" is asked for).
//
// Threading: any host thread may call process(); each entry point takes the
// GIL via PyGILState_Ensure. When this library boots the interpreter itself
// (a C host), the boot thread releases the GIL afterwards so other threads
// can enter. When loaded INTO a Python process (ctypes),
// Py_IsInitialized() short-circuits the boot.
//
// Memory: process()/get_serving_model_info() malloc the output buffer; the
// caller frees it with free() (or the exported free_buffer alias).
//
// Build: deeprec_tpu_torch.native.load_processor_library() compiles it at
// first use with g++ against the running interpreter's headers and
// libpython (sysconfig's INCLUDEPY, LIBDIR and LDLIBRARY).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>

namespace {

struct ProcessorState {
  PyObject* server;        // deeprec_tpu_torch.serving.ModelServer
  PyObject* process_fn;    // cabi.process_request (JSON or protobuf)
  PyObject* info_fn;       // cabi.model_info_json
};

// Copy a Python (status, bytes) tuple into a malloc'd C buffer.
int unpack_reply(PyObject* res, void** output_data, int* output_size) {
  if (res == nullptr) {
    PyErr_Print();
    return -1;
  }
  int status = -1;
  PyObject* body = nullptr;
  if (PyTuple_Check(res) && PyTuple_Size(res) == 2) {
    status = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(res, 0)));
    body = PyTuple_GetItem(res, 1);  // borrowed
  }
  if (body != nullptr && PyBytes_Check(body)) {
    Py_ssize_t n = PyBytes_Size(body);
    void* buf = std::malloc(static_cast<size_t>(n));
    if (buf != nullptr) {
      std::memcpy(buf, PyBytes_AsString(body), static_cast<size_t>(n));
      *output_data = buf;
      *output_size = static_cast<int>(n);
    } else {
      status = -1;
    }
  } else {
    status = -1;
  }
  Py_DECREF(res);
  return status;
}

}  // namespace

extern "C" {

// model_entry: unused slot kept for ABI compatibility (the reference passes
// a SavedModel path here; the model comes from the config's registry name
// and ckpt_dir). model_config: JSON, see cabi.create_server.
// On success *state = 0 and the returned handle is passed to process();
// on failure returns nullptr and *state = -1.
void* initialize(const char* model_entry, const char* model_config,
                 int* state) {
  (void)model_entry;
  bool booted_here = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    booted_here = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  ProcessorState* ps = nullptr;
  PyObject* mod = PyImport_ImportModule("deeprec_tpu_torch.serving.cabi");
  if (mod != nullptr) {
    PyObject* create = PyObject_GetAttrString(mod, "create_server");
    PyObject* server =
        create ? PyObject_CallFunction(create, "s", model_config) : nullptr;
    if (server != nullptr) {
      ps = new ProcessorState();
      ps->server = server;
      ps->process_fn = PyObject_GetAttrString(mod, "process_request");
      ps->info_fn = PyObject_GetAttrString(mod, "model_info_json");
    }
    Py_XDECREF(create);
    Py_DECREF(mod);
  }
  if (ps == nullptr) {
    PyErr_Print();
  }
  if (state != nullptr) {
    *state = ps != nullptr ? 0 : -1;
  }
  PyGILState_Release(gil);
  if (booted_here) {
    // Release the GIL held by the booting thread so process() may be
    // called from any host thread.
    PyEval_SaveThread();
  }
  return ps;
}

int get_serving_model_info(void* model_buf, void** output_data,
                           int* output_size);

// The predict path without the empty-payload ping (batch_process_n keeps
// per-request 400 semantics for a zero-size request).
static int process_predict(void* model_buf, const void* input_data,
                           int input_size, void** output_data,
                           int* output_size) {
  if (model_buf == nullptr || output_data == nullptr ||
      output_size == nullptr) {
    return -1;
  }
  auto* ps = static_cast<ProcessorState*>(model_buf);
  static const char kEmpty[] = "";
  const char* data =
      input_data != nullptr ? static_cast<const char*>(input_data) : kEmpty;
  int size = input_data != nullptr ? input_size : 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* res = PyObject_CallFunction(
      ps->process_fn, "Oy#", ps->server, data,
      static_cast<Py_ssize_t>(size));
  int status = unpack_reply(res, output_data, output_size);
  PyGILState_Release(gil);
  return status;
}

// Returns the serving status code (200/400/500, mirroring the HTTP
// frontend) or -1 on an internal error. *output_data is malloc'd JSON.
// input_size == 0 mirrors the reference (processor.cc:29-34): the model's
// debug/serving info is returned with status 200 — hosts use an empty
// payload as a liveness + introspection ping.
int process(void* model_buf, const void* input_data, int input_size,
            void** output_data, int* output_size) {
  if (input_size == 0) {
    return get_serving_model_info(model_buf, output_data, output_size);
  }
  return process_predict(model_buf, input_data, input_size, output_data,
                         output_size);
}

// Reference-ABI batch entry point. The ABI has no request count anywhere
// (processor.h:8), and the reference implementation resolves that with
// `sizeof(input_data)/sizeof(void*)` (message_coding.cc:79) — i.e. it
// ALWAYS processes exactly one request, whatever the host meant to pass.
// Hosts coded against the reference therefore observe batch-of-1
// semantics, and they do NOT null-terminate the array, so walking it here
// would read out of bounds. We match the observable reference behavior:
// exactly one request. A null input_size mirrors the reference's
// `if (input_size == 0)` pointer check: return model debug info. Hosts
// that want real batching use batch_process_n (explicit count, below).
int batch_process(void* model_buf, const void* input_data[], int* input_size,
                  void* output_data[], int* output_size) {
  if (model_buf == nullptr || output_data == nullptr ||
      output_size == nullptr) {
    return -1;
  }
  if (input_data == nullptr || input_size == nullptr) {
    return get_serving_model_info(model_buf, &output_data[0],
                                  &output_size[0]);
  }
  return process(model_buf, input_data[0], input_size[0], &output_data[0],
                 &output_size[0]);
}

// Extension (not in the reference ABI): batch with an explicit request
// count. Per-request statuses are not folded — the return is the first
// non-200 status, each output buffer carries its own error body. An empty
// (size-0) request is a client error for its slot, not an info ping — the
// ping semantic belongs to the single-request reference entry points only.
int batch_process_n(void* model_buf, const void* input_data[],
                    int* input_size, int num_requests, void* output_data[],
                    int* output_size) {
  if (model_buf == nullptr || input_data == nullptr ||
      input_size == nullptr || output_data == nullptr ||
      output_size == nullptr) {
    return -1;
  }
  int first_bad = 200;
  for (int i = 0; i < num_requests; ++i) {
    int rc = process_predict(model_buf, input_data[i], input_size[i],
                             &output_data[i], &output_size[i]);
    if (rc != 200 && first_bad == 200) {
      first_bad = rc;
    }
  }
  return first_bad;
}

int get_serving_model_info(void* model_buf, void** output_data,
                           int* output_size) {
  if (model_buf == nullptr || output_data == nullptr ||
      output_size == nullptr) {
    return -1;
  }
  auto* ps = static_cast<ProcessorState*>(model_buf);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* res = PyObject_CallFunction(ps->info_fn, "O", ps->server);
  int status = unpack_reply(res, output_data, output_size);
  PyGILState_Release(gil);
  return status;
}

void free_buffer(void* buf) { std::free(buf); }

// Stop the coalescing worker and drop the Python references. The
// interpreter itself is left running (it may be the host's).
void shutdown_processor(void* model_buf) {
  if (model_buf == nullptr) {
    return;
  }
  auto* ps = static_cast<ProcessorState*>(model_buf);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* closed = PyObject_CallMethod(ps->server, "close", nullptr);
  Py_XDECREF(closed);
  Py_XDECREF(ps->process_fn);
  Py_XDECREF(ps->info_fn);
  Py_DECREF(ps->server);
  PyGILState_Release(gil);
  delete ps;
}

}  // extern "C"
