/* Pure-C serving host — the port's copy of
 * `deeprec_tpu/native/chost_demo.c`.
 *
 * dlopens the processor library (native/processor.cpp) with NO Python
 * running, exercising the embedded-interpreter boot branch of initialize()
 * that ctypes callers short-circuit: initialize with a JSON model config,
 * process one request, print the body, shut down. Build it with
 * `deeprec_tpu_torch.native.build_chost_demo()` (cc -O2 ... -ldl).
 *
 * Usage: chost_demo <libdeeprec_processor.so> <model_config.json> <req file>
 * Exits 0 iff initialize returns state 0 and process returns 200.
 */
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef void* (*initialize_fn)(const char*, const char*, int*);
typedef int (*process_fn)(void*, const void*, int, void**, int*);
typedef void (*free_fn)(void*);
typedef void (*shutdown_fn)(void*);

static char* read_file(const char* path, long* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return NULL;
  }
  long n = ftell(f);
  if (n < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return NULL;  /* unseekable input (pipe/FIFO) */
  }
  char* buf = malloc((size_t)n + 1);
  if (!buf) {
    fclose(f);
    return NULL;
  }
  if (fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    free(buf);
    return NULL;
  }
  buf[n] = 0;
  fclose(f);
  *out_len = n;
  return buf;
}

int main(int argc, char** argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s <lib.so> <config.json> <request file>\n",
            argv[0]);
    return 2;
  }
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen: %s\n", dlerror());
    return 2;
  }
  initialize_fn init = (initialize_fn)dlsym(lib, "initialize");
  process_fn process = (process_fn)dlsym(lib, "process");
  free_fn free_buffer = (free_fn)dlsym(lib, "free_buffer");
  shutdown_fn shutdown = (shutdown_fn)dlsym(lib, "shutdown_processor");
  if (!init || !process || !free_buffer || !shutdown) {
    fprintf(stderr, "missing ABI symbol\n");
    return 2;
  }

  long cfg_len = 0, req_len = 0;
  char* cfg = read_file(argv[2], &cfg_len);
  char* req = read_file(argv[3], &req_len);
  if (!cfg || !req) {
    fprintf(stderr, "cannot read config/request\n");
    return 2;
  }

  int state = -7;
  void* model = init("", cfg, &state);
  if (state != 0 || !model) {
    fprintf(stderr, "initialize failed: state=%d\n", state);
    return 3;
  }

  void* out = NULL;
  int out_len = 0;
  int rc = process(model, req, (int)req_len, &out, &out_len);
  printf("process rc=%d body=%.*s\n", rc, out_len, (char*)out);
  if (out) free_buffer(out);
  shutdown(model);
  free(cfg);
  free(req);
  return rc == 200 ? 0 : 4;
}
