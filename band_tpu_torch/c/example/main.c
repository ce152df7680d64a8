/* Minimal C client of the band-tpu-torch C API (role-equivalent to the
 * reference's band/c/example/band_c_main.c): build a config, register a
 * model, run sync and async requests, and check the output.
 *
 * Usage: main <model.tflite> [config.json [input.bin output_prefix
 *             [n_timed]]]
 *   config.json   the runtime config (workers name the devices); without
 *                 it an inline config runs two CPU workers under a
 *                 fixed-worker scheduler.
 *   input.bin     one or more requests' input tensor 0, back to back
 *                 (else one request of zeros, or of 2.0 for a float32
 *                 input); each is served by BandEngineRequestSync.
 *   output_prefix every request's output tensor i is appended, in
 *                 request order, to <output_prefix>.<i>.
 *   n_timed       time that many BandEngineRequestSync calls of the last
 *                 request after two untimed ones (prints
 *                 c_api_ms_per_request).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "band_c.h"

enum { kMaxOutputs = 16 };

static volatile int g_callback_count = 0;
static volatile int g_log_count = 0;

static void on_end(void* user_data, int job_id, BandStatus status) {
  (void)user_data;
  (void)job_id;
  if (status == kBandOk) g_callback_count++;
}

static void on_log(BandLogSeverity severity, const char* msg) {
  (void)severity;
  (void)msg;
  g_log_count++;
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static unsigned char* read_all(const char* path, size_t* n) {
  FILE* f = fopen(path, "rb");
  if (f == NULL) return NULL;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  unsigned char* data = malloc(size > 0 ? (size_t)size : 1);
  *n = fread(data, 1, (size_t)size, f);
  fclose(f);
  return data;
}

int main(int argc, char** argv) {
  setvbuf(stdout, NULL, _IONBF, 0); /* keep prints on crash */
  if (argc < 2) {
    fprintf(stderr,
            "usage: %s <model.tflite> [config.json [input.bin "
            "output_prefix [n_timed]]]\n",
            argv[0]);
    return 2;
  }
  const char* input_path = argc > 4 ? argv[3] : NULL;
  const char* output_prefix = argc > 4 ? argv[4] : NULL;
  int n_timed = argc > 5 ? atoi(argv[5]) : 0;

  BandSetLogSeverity(kBandLogDebug);
  int log_handle = BandSetLogReporter(on_log);
  printf("log_reporter=%d\n", log_handle >= 0);

  BandConfig* config = NULL;
  if (argc > 2) {
    config = BandConfigCreateFromFile(argv[2]);
  } else {
    BandConfigBuilder* b = BandConfigBuilderCreate();
    if (BandAddConfigJson(
            b,
            "{\"schedulers\": [\"fixed_worker\"],"
            " \"workers\": [{\"device\": \"cpu\", \"device_ids\": [0]},"
            "               {\"device\": \"cpu\", \"device_ids\": [1]}],"
            " \"profile_num_warmups\": 0, \"profile_num_runs\": 1}") !=
        kBandOk) {
      fprintf(stderr, "config error: %s\n", BandGetLastError());
      return 1;
    }
    /* exercise the dotted-key setter too */
    BandAddConfigKV(b, "planner.schedule_window_size", "8");
    config = BandConfigCreate(b);
    BandConfigBuilderDelete(b);
  }
  if (config == NULL) {
    fprintf(stderr, "config create failed: %s\n", BandGetLastError());
    return 1;
  }

  BandEngine* engine = BandEngineCreate(config);
  if (engine == NULL) {
    fprintf(stderr, "engine create failed: %s\n", BandGetLastError());
    return 1;
  }
  printf("num_workers=%d worker0_device=%d\n", BandEngineGetNumWorkers(engine),
         (int)BandEngineGetWorkerDevice(engine, 0));

  BandModel* model = BandModelCreate();
  if (BandModelAddFromFile(model, argv[1]) != kBandOk ||
      BandEngineRegisterModel(engine, model) != kBandOk) {
    fprintf(stderr, "register failed: %s\n", BandGetLastError());
    return 1;
  }

  int n_in = BandEngineGetNumInputTensors(engine, model);
  int n_out = BandEngineGetNumOutputTensors(engine, model);
  printf("inputs=%d outputs=%d\n", n_in, n_out);
  if (n_in != 1 || n_out < 1 || n_out > kMaxOutputs) return 1;

  BandTensor* in0 = BandEngineCreateInputTensor(engine, model, 0);
  BandTensor* outs[kMaxOutputs];
  for (int i = 0; i < n_out; ++i) {
    outs[i] = BandEngineCreateOutputTensor(engine, model, i);
    if (outs[i] == NULL) {
      fprintf(stderr, "tensor create failed: %s\n", BandGetLastError());
      return 1;
    }
  }
  if (in0 == NULL) {
    fprintf(stderr, "tensor create failed: %s\n", BandGetLastError());
    return 1;
  }
  printf("in0 dims=%zu bytes=%zu type=%d\n", BandTensorGetNumDims(in0),
         BandTensorGetBytes(in0), (int)BandTensorGetType(in0));

  /* quantization introspection (affine for int8/uint8 models) */
  BandQuantizationType qt = BandTensorGetQuantizationType(in0);
  printf("quant_type=%d\n", (int)qt);
  if (qt == kBandAffineQuantization) {
    BandAffineQuantization* q =
        (BandAffineQuantization*)BandTensorGetQuantizationParams(in0);
    printf("quant num=%d scale0=%.6f zp0=%d dim=%d\n", q->num_params,
           q->scales[0], q->zero_points[0], q->quantized_dimension);
  }

  size_t in_bytes = BandTensorGetBytes(in0);
  unsigned char* requests = NULL;
  size_t n_requests = 1;
  if (input_path != NULL) {
    size_t n = 0;
    requests = read_all(input_path, &n);
    if (requests == NULL || n == 0 || n % in_bytes != 0) {
      fprintf(stderr, "%s does not hold whole requests of %zu bytes\n",
              input_path, in_bytes);
      return 1;
    }
    n_requests = n / in_bytes;
  } else if (BandTensorGetType(in0) == kBandFloat32) {
    float* p = (float*)BandTensorGetData(in0);
    size_t n = in_bytes / sizeof(float);
    for (size_t i = 0; i < n; ++i) p[i] = 2.0f;
  }

  int cb_handle = BandEngineSetOnEndRequest(engine, on_end, NULL);

  FILE* out_files[kMaxOutputs] = {NULL};
  if (output_prefix != NULL) {
    char path[4096];
    for (int i = 0; i < n_out; ++i) {
      snprintf(path, sizeof path, "%s.%d", output_prefix, i);
      out_files[i] = fopen(path, "wb");
      if (out_files[i] == NULL) {
        fprintf(stderr, "cannot write %s\n", path);
        return 1;
      }
    }
  }
  BandTensor* ins[1] = {in0};
  for (size_t r = 0; r < n_requests; ++r) {
    if (requests != NULL) {
      memcpy(BandTensorGetData(in0), requests + r * in_bytes, in_bytes);
    }
    if (BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
      fprintf(stderr, "request %zu failed: %s\n", r, BandGetLastError());
      return 1;
    }
    for (int i = 0; i < n_out && out_files[0] != NULL; ++i) {
      size_t nb = BandTensorGetBytes(outs[i]);
      if (fwrite(BandTensorGetData(outs[i]), 1, nb, out_files[i]) != nb) {
        fprintf(stderr, "cannot write output %d\n", i);
        return 1;
      }
    }
  }
  for (int i = 0; i < n_out && out_files[0] != NULL; ++i) {
    if (fclose(out_files[i]) != 0) return 1;
  }
  free(requests);
  printf("served %zu requests\n", n_requests);
  if (output_prefix != NULL) printf("wrote %d outputs\n", n_out);
  if (BandTensorGetType(outs[0]) == kBandFloat32) {
    const float* q = (const float*)BandTensorGetData(outs[0]);
    printf("sync out[0]=%f\n", q[0]);
  }
  size_t out0_bytes = BandTensorGetBytes(outs[0]);
  unsigned char* sync0 = malloc(out0_bytes);
  memcpy(sync0, BandTensorGetData(outs[0]), out0_bytes);

  /* async + wait, with an explicit option */
  BandRequestOption opt = BandRequestOptionGetDefault();
  opt.slo_us = 10 * 1000 * 1000; /* generous 10 s SLO */
  BandRequestHandle h =
      BandEngineRequestAsyncOptions(engine, model, opt, ins);
  if (h < 0) {
    fprintf(stderr, "async failed: %s\n", BandGetLastError());
    return 1;
  }
  if (BandEngineWait(engine, h, outs, n_out) != kBandOk) {
    fprintf(stderr, "wait failed: %s\n", BandGetLastError());
    return 1;
  }
  if (BandTensorGetType(outs[0]) == kBandFloat32) {
    const float* q = (const float*)BandTensorGetData(outs[0]);
    printf("async out[0]=%f\n", q[0]);
  }
  printf("async_equals_sync=%d\n",
         memcmp(sync0, BandTensorGetData(outs[0]), out0_bytes) == 0);
  free(sync0);
  printf("callbacks=%d\n", g_callback_count);

  /* unregistering stops further callbacks */
  if (BandEngineUnsetOnEndRequest(engine, cb_handle) != kBandOk) {
    fprintf(stderr, "unset callback failed: %s\n", BandGetLastError());
    return 1;
  }
  if (BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
    fprintf(stderr, "request after unset failed: %s\n", BandGetLastError());
    return 1;
  }
  printf("callbacks_after_unset=%d\n", g_callback_count);

  if (n_timed > 0) {
    /* closed loop at b1: one caller, BandEngineRequestSync back to back
     * on the last request */
    for (int i = 0; i < 2; ++i) {
      if (BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
        fprintf(stderr, "warm-up request failed: %s\n", BandGetLastError());
        return 1;
      }
    }
    double t0 = now_ms();
    for (int i = 0; i < n_timed; ++i) {
      if (BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
        fprintf(stderr, "timed request failed: %s\n", BandGetLastError());
        return 1;
      }
    }
    double ms = (now_ms() - t0) / n_timed;
    printf("c_api_ms_per_request=%.4f c_api_req_s=%.3f n=%d\n", ms,
           1000.0 / ms, n_timed);
  }

  /* default-config engine: one worker per card + host worker */
  BandEngine* dflt = BandEngineCreateWithDefaultConfig();
  printf("default_engine=%d default_workers=%d\n", dflt != NULL,
         dflt != NULL ? BandEngineGetNumWorkers(dflt) : -1);
  BandEngineDelete(dflt);

  /* hot swap: unregister, then further requests must fail cleanly */
  if (BandEngineUnregisterModel(engine, model) != kBandOk) {
    fprintf(stderr, "unregister failed: %s\n", BandGetLastError());
    return 1;
  }
  int post = BandEngineRequestSync(engine, model, ins, outs);
  printf("unregistered=1 request_after_unregister_fails=%d\n",
         post != kBandOk);

  BandTensorDelete(in0);
  for (int i = 0; i < n_out; ++i) BandTensorDelete(outs[i]);
  BandModelDelete(model);
  BandEngineDelete(engine);
  BandConfigDelete(config);
  BandUnsetLogReporter(log_handle);
  printf("C API OK\n");
  return 0;
}
