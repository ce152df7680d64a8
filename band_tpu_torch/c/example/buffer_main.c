/* C client for the buffer + image-processor surface of the
 * band-tpu-torch C API (role-equivalent to the reference's c_api_buffer
 * usage, see band/c/c_api_buffer.h): build buffers from raw RGB / NV21 /
 * strided I420 data, run automatic and explicit pipelines into a model
 * input tensor, and feed the result through inference.
 *
 * Usage: buffer_main <model.tflite> <config.json>
 *                    [frame.bin width height format tensor.bin
 *                     output_prefix [n_timed]]
 *   The model has one image input [1, H, W, 3] (float32, int8 or uint8).
 *   Checks: the automatic pipeline, crop, flip, rotate (square inputs),
 *   NV21 and strided I420 buffers, one inference, the arity check.
 *   With frames: frame.bin holds one or more width x height frames in
 *   BandBufferFormat `format` (1 = RGB, 6 = NV12, ...), back to back as a
 *   camera delivers them; the automatic pipeline turns each into input 0
 *   (appended to tensor.bin), and a sync request's output tensor i is
 *   appended to <output_prefix>.<i>.  n_timed times that many runs of the
 *   first frame, each processed and served (prints
 *   c_buffer_ms_per_request).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "band_c.h"

enum { kMaxOutputs = 16 };

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

/* The value a pixel code v takes in the tensor's type: DATA_TYPE_CONVERT
 * casts uint8 codes, so int8 wraps codes above 127. */
static double code_as(BandTensor* t, int v) {
  switch (BandTensorGetType(t)) {
    case kBandInt8:
      return (double)(signed char)(unsigned char)v;
    case kBandUInt8:
      return (double)(unsigned char)v;
    default:
      return (double)v;
  }
}

static double value_at(BandTensor* t, size_t i) {
  const void* d = BandTensorGetData(t);
  switch (BandTensorGetType(t)) {
    case kBandFloat32:
      return ((const float*)d)[i];
    case kBandInt8:
      return ((const signed char*)d)[i];
    case kBandUInt8:
      return ((const unsigned char*)d)[i];
    default:
      return -1e9;
  }
}

static int near(double a, double b) { return a > b - 0.5 && a < b + 0.5; }

static int process(BandImageProcessor* p, BandBuffer* buf, BandTensor* t,
                   const char* what) {
  if (BandImageProcessorProcess(p, buf, t) != kBandOk) {
    fprintf(stderr, "%s failed: %s\n", what, BandGetLastError());
    return 0;
  }
  return 1;
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

/* Bytes of one raw frame (band_c.h BandBufferSetFromRawData's layout). */
static size_t frame_size(BandBufferFormat f, size_t w, size_t h) {
  size_t cw = (w + 1) / 2, ch = (h + 1) / 2;
  switch (f) {
    case kBandGrayScale: return w * h;
    case kBandRGB: return w * h * 3;
    case kBandRGBA: return w * h * 4;
    case kBandNV12:
    case kBandNV21: return w * h + w * ch;
    case kBandYV12:
    case kBandYV21: return w * h + 2 * cw * ch;
    default: return 0;
  }
}

/* gradient along x, every code below 128 so no type wraps it */
static unsigned char grad(int x) { return (unsigned char)((x * 7) % 101); }

int main(int argc, char** argv) {
  setvbuf(stdout, NULL, _IONBF, 0);
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s <model.tflite> <config.json> [frame.bin width "
            "height format tensor.bin output_prefix [n_timed]]\n",
            argv[0]);
    return 2;
  }
  BandConfig* config = BandConfigCreateFromFile(argv[2]);
  BandEngine* engine = config != NULL ? BandEngineCreate(config) : NULL;
  BandModel* model = BandModelCreate();
  if (engine == NULL || BandModelAddFromFile(model, argv[1]) != kBandOk ||
      BandEngineRegisterModel(engine, model) != kBandOk) {
    fprintf(stderr, "setup failed: %s\n", BandGetLastError());
    return 1;
  }
  int n_out = BandEngineGetNumOutputTensors(engine, model);
  BandTensor* in0 = BandEngineCreateInputTensor(engine, model, 0);
  BandTensor* outs[kMaxOutputs];
  if (in0 == NULL || n_out < 1 || n_out > kMaxOutputs ||
      BandTensorGetNumDims(in0) != 4 || BandTensorGetDims(in0)[3] != 3) {
    fprintf(stderr, "needs one [1, H, W, 3] input: %s\n", BandGetLastError());
    return 1;
  }
  for (int i = 0; i < n_out; ++i) {
    outs[i] = BandEngineCreateOutputTensor(engine, model, i);
    if (outs[i] == NULL) {
      fprintf(stderr, "tensor setup failed: %s\n", BandGetLastError());
      return 1;
    }
  }
  const int H = BandTensorGetDims(in0)[1], W = BandTensorGetDims(in0)[2];

  /* 2W x 2H RGB: left half 100, right half 120. */
  unsigned char* rgb = malloc((size_t)4 * H * W * 3);
  for (int y = 0; y < 2 * H; ++y)
    for (int x = 0; x < 2 * W; ++x)
      for (int c = 0; c < 3; ++c)
        rgb[((size_t)y * 2 * W + x) * 3 + c] =
            (unsigned char)(x < W ? 100 : 120);
  BandBuffer* buf = BandBufferCreate();
  if (BandBufferSetFromRawData(buf, rgb, 2 * W, 2 * H, kBandRGB) != kBandOk) {
    fprintf(stderr, "set raw failed: %s\n", BandGetLastError());
    return 1;
  }

  /* 1) Empty builder: automatic resize 2W x 2H -> W x H + dtype. */
  BandImageProcessorBuilder* b1 = BandImageProcessorBuilderCreate();
  BandImageProcessor* p1 = BandImageProcessorBuilderBuild(b1);
  if (!process(p1, buf, in0, "auto")) return 1;
  double left = value_at(in0, 0), right = value_at(in0, (size_t)(W - 1) * 3);
  printf("auto left=%.1f right=%.1f ok=%d\n", left, right,
         near(left, 100) && near(right, 120));

  /* 2) Crop the top right quarter (W x H) + dtype convert: 120. */
  BandImageProcessorBuilder* b2 = BandImageProcessorBuilderCreate();
  if (BandAddOperator(b2, BAND_CROP, 4, W, 0, 2 * W - 1, H - 1) != kBandOk ||
      BandAddOperator(b2, BAND_DATA_TYPE_CONVERT, 0) != kBandOk) {
    fprintf(stderr, "add operator failed: %s\n", BandGetLastError());
    return 1;
  }
  BandImageProcessor* p2 = BandImageProcessorBuilderBuild(b2);
  if (!process(p2, buf, in0, "crop")) return 1;
  printf("crop=%.1f ok=%d\n", value_at(in0, 0), near(value_at(in0, 0), 120));

  /* 3) Flip / rotate on a W x H column gradient. */
  unsigned char* g = malloc((size_t)H * W * 3);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < 3; ++c) g[((size_t)y * W + x) * 3 + c] = grad(x);
  BandBufferSetFromRawData(buf, g, W, H, kBandRGB);

  BandImageProcessorBuilder* b3 = BandImageProcessorBuilderCreate();
  BandAddOperator(b3, BAND_FLIP, 2, 1, 0);
  BandAddOperator(b3, BAND_DATA_TYPE_CONVERT, 0);
  BandImageProcessor* p3 = BandImageProcessorBuilderBuild(b3);
  if (!process(p3, buf, in0, "flip")) return 1;
  printf("flip=%.1f ok=%d\n", value_at(in0, 0),
         near(value_at(in0, 0), grad(W - 1)));

  BandImageProcessorBuilder* b4 = BandImageProcessorBuilderCreate();
  BandAddOperator(b4, BAND_ROTATE, 1, 90);
  BandAddOperator(b4, BAND_DATA_TYPE_CONVERT, 0);
  BandImageProcessor* p4 = BandImageProcessorBuilderBuild(b4);
  if (H == W) {
    /* counter-clockwise: the output's first row is the input's last
     * column */
    if (!process(p4, buf, in0, "rotate")) return 1;
    printf("rotate=%.1f ok=%d\n", value_at(in0, 0),
           near(value_at(in0, 0), grad(W - 1)));
  }

  /* 4) NV21 from a single blob: Y=128, VU=128 -> RGB 130 (BT.601). */
  size_t nv_bytes = (size_t)4 * H * W + (size_t)2 * H * W;
  unsigned char* nv21 = malloc(nv_bytes);
  memset(nv21, 128, nv_bytes);
  if (BandBufferSetFromRawData(buf, nv21, 2 * W, 2 * H, kBandNV21) !=
      kBandOk) {
    fprintf(stderr, "nv21 set failed: %s\n", BandGetLastError());
    return 1;
  }
  if (!process(p1, buf, in0, "nv21")) return 1;
  printf("nv21=%.1f ok=%d\n", value_at(in0, 0),
         near(value_at(in0, 0), code_as(in0, 130)));

  /* 5) Strided I420 planes via the YUV entry point (row padding). */
  const int ys = 2 * W + 4, cs = W + 4;
  unsigned char* yp = malloc((size_t)ys * 2 * H);
  unsigned char* up = malloc((size_t)cs * H);
  unsigned char* vp = malloc((size_t)cs * H);
  memset(yp, 128, (size_t)ys * 2 * H);
  memset(up, 128, (size_t)cs * H);
  memset(vp, 128, (size_t)cs * H);
  if (BandBufferSetFromYUVData(buf, yp, up, vp, 2 * W, 2 * H, ys, cs, 1,
                               kBandYV21) != kBandOk) {
    fprintf(stderr, "yuv set failed: %s\n", BandGetLastError());
    return 1;
  }
  if (!process(p1, buf, in0, "yuv")) return 1;
  printf("yuv=%.1f ok=%d\n", value_at(in0, 0),
         near(value_at(in0, 0), code_as(in0, 130)));

  /* 6) The processed tensor feeds inference. */
  BandTensor* ins[1] = {in0};
  if (BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
    fprintf(stderr, "request failed: %s\n", BandGetLastError());
    return 1;
  }
  printf("sync ok=1\n");

  /* error surface: wrong arity is rejected */
  BandImageProcessorBuilder* bad = BandImageProcessorBuilderCreate();
  printf("bad_arity=%d\n", BandAddOperator(bad, BAND_CROP, 2, 1, 2));
  BandImageProcessorBuilderDelete(bad);

  /* 7) Camera frames through the automatic pipeline, then served. */
  if (argc > 8) {
    size_t n = 0;
    unsigned char* frames = read_all(argv[3], &n);
    int fw = atoi(argv[4]), fh = atoi(argv[5]);
    BandBufferFormat fmt = (BandBufferFormat)atoi(argv[6]);
    int n_timed = argc > 9 ? atoi(argv[9]) : 0;
    size_t one = frame_size(fmt, (size_t)fw, (size_t)fh);
    if (frames == NULL || one == 0 || n == 0 || n % one != 0) {
      fprintf(stderr, "%s does not hold whole %dx%d frames of format %d\n",
              argv[3], fw, fh, (int)fmt);
      return 1;
    }
    FILE* tensor_file = fopen(argv[7], "wb");
    FILE* out_files[kMaxOutputs];
    char path[4096];
    for (int i = 0; i < n_out; ++i) {
      snprintf(path, sizeof path, "%s.%d", argv[8], i);
      out_files[i] = fopen(path, "wb");
      if (out_files[i] == NULL) {
        fprintf(stderr, "cannot write %s\n", path);
        return 1;
      }
    }
    if (tensor_file == NULL) {
      fprintf(stderr, "cannot write %s\n", argv[7]);
      return 1;
    }
    for (size_t k = 0; k < n / one; ++k) {
      if (BandBufferSetFromRawData(buf, frames + k * one, fw, fh, fmt) !=
              kBandOk ||
          !process(p1, buf, in0, "frame") ||
          BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
        fprintf(stderr, "frame %zu: %s\n", k, BandGetLastError());
        return 1;
      }
      size_t tb = BandTensorGetBytes(in0);
      if (fwrite(BandTensorGetData(in0), 1, tb, tensor_file) != tb) return 1;
      for (int i = 0; i < n_out; ++i) {
        size_t ob = BandTensorGetBytes(outs[i]);
        if (fwrite(BandTensorGetData(outs[i]), 1, ob, out_files[i]) != ob) {
          return 1;
        }
      }
    }
    if (fclose(tensor_file) != 0) return 1;
    for (int i = 0; i < n_out; ++i) {
      if (fclose(out_files[i]) != 0) return 1;
    }
    printf("frames %zu of %dx%d format %d: wrote tensors and %d outputs\n",
           n / one, fw, fh, (int)fmt, n_out);
    if (n_timed > 0) {
      /* closed loop at b1: process the first frame, serve it, back to
       * back */
      double t0 = now_ms();
      for (int i = 0; i < n_timed; ++i) {
        if (BandBufferSetFromRawData(buf, frames, fw, fh, fmt) != kBandOk ||
            !process(p1, buf, in0, "timed frame") ||
            BandEngineRequestSync(engine, model, ins, outs) != kBandOk) {
          fprintf(stderr, "timed frame failed: %s\n", BandGetLastError());
          return 1;
        }
      }
      double ms = (now_ms() - t0) / n_timed;
      printf("c_buffer_ms_per_request=%.4f c_buffer_req_s=%.3f n=%d\n", ms,
             1000.0 / ms, n_timed);
    }
    free(frames);
  }

  BandImageProcessorDelete(p1);
  BandImageProcessorDelete(p2);
  BandImageProcessorDelete(p3);
  BandImageProcessorDelete(p4);
  BandImageProcessorBuilderDelete(b1);
  BandImageProcessorBuilderDelete(b2);
  BandImageProcessorBuilderDelete(b3);
  BandImageProcessorBuilderDelete(b4);
  BandBufferDelete(buf);
  BandTensorDelete(in0);
  for (int i = 0; i < n_out; ++i) BandTensorDelete(outs[i]);
  BandModelDelete(model);
  BandEngineDelete(engine);
  BandConfigDelete(config);
  free(rgb);
  free(g);
  free(nv21);
  free(yp);
  free(up);
  free(vp);
  printf("BUFFER API OK\n");
  return 0;
}
