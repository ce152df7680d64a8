/* band-tpu-torch C API.
 *
 * The C ABI of band_tpu/c/band_c.h, unchanged (the same Band* names,
 * enums and signatures), over the PyTorch engine of band_tpu_torch.  It
 * has the same surface as the reference's C API (reference:
 * band/c/c_api.h:46-140): opaque handles for config-builder / config /
 * model / tensor / engine, synchronous and asynchronous requests with
 * per-request options, wait, end-of-request callbacks, and the buffer +
 * image-processor surface (band/c/c_api_buffer.h).
 *
 * Differences from the reference, by design:
 *  - Config is composed from JSON fragments / dotted keys instead of the
 *    varargs BandAddConfig(field_enum, count, ...) protocol; the JSON
 *    schema is the same one the benchmark tool and the Python API accept
 *    (reference schema: band/docs/config.md), so C callers can reuse
 *    reference config files verbatim.
 *  - The library embeds a CPython interpreter (the runtime control plane
 *    is Python driving CUDA kernels); link against
 *    libband_tpu_torch_c.so and set PYTHONPATH so `band_tpu_torch` and
 *    torch are importable.  The config's workers name the devices: a
 *    "gpu" worker runs on a CUDA card (engine creation fails without
 *    one), a "cpu" worker on the host.
 *
 * Thread-safety: all functions may be called from any thread; calls are
 * serialized on the embedded interpreter's GIL.  Engine execution itself
 * happens on internal worker threads and CUDA streams; the GIL is only
 * held for control-plane transitions.
 */

#ifndef BAND_TPU_TORCH_C_BAND_C_H_
#define BAND_TPU_TORCH_C_BAND_C_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct BandConfigBuilder BandConfigBuilder;
typedef struct BandConfig BandConfig;
typedef struct BandModel BandModel;
typedef struct BandTensor BandTensor;
typedef struct BandEngine BandEngine;
typedef int BandRequestHandle;

typedef enum BandStatus {
  kBandOk = 0,
  kBandError = 1,
  kBandDeadlineExceeded = 2,
} BandStatus;

typedef enum BandDataType {
  kBandNoType = 0,
  kBandFloat32 = 1,
  kBandInt32 = 2,
  kBandUInt8 = 3,
  kBandInt64 = 4,
  kBandString = 5,
  kBandBool = 6,
  kBandInt16 = 7,
  kBandComplex64 = 8,
  kBandInt8 = 9,
  kBandFloat16 = 10,
  kBandFloat64 = 11,
} BandDataType;

typedef enum BandDeviceFlag {
  kBandCpu = 0,
  kBandTpu = 1,
  kBandTpuMesh = 2,
  /* the accelerator worker of this build: a CUDA card (same value as
   * kBandTpu, so the ABI is band_tpu's) */
  kBandGpu = 1,
} BandDeviceFlag;

typedef struct BandRequestOption {
  int target_worker;   /* -1: let the scheduler decide */
  int require_callback; /* 0/1 */
  int slo_us;          /* -1: no SLO */
  float slo_scale;     /* -1: unused; else slo = worst_latency * scale */
} BandRequestOption;

typedef enum BandLogSeverity {
  kBandLogInternal = 0,
  kBandLogDebug = 1,
  kBandLogInfo = 2,
  kBandLogWarning = 3,
  kBandLogError = 4,
} BandLogSeverity;

/* -- logging (reference: band/c/c_api.h BandSetLogSeverity/Reporter) --- */
void BandSetLogSeverity(BandLogSeverity severity);
/* Route engine logs into a C callback; returns a handle or -1. */
int BandSetLogReporter(void (*reporter)(BandLogSeverity severity,
                                        const char* msg));
void BandUnsetLogReporter(int handle);

/* Last error message of the calling thread ("" if none). Valid until the
 * next API call from the same thread. */
const char* BandGetLastError(void);

/* -- config ------------------------------------------------------------ */
BandConfigBuilder* BandConfigBuilderCreate(void);
void BandConfigBuilderDelete(BandConfigBuilder* b);
/* Merge a JSON object (text) into the builder state. */
BandStatus BandAddConfigJson(BandConfigBuilder* b, const char* json_text);
/* Set one dotted key, e.g. ("planner.schedule_window_size", "8") or
 * ("schedulers", "[\"heft\"]"); the value is parsed as JSON when
 * possible, else taken as a string. */
BandStatus BandAddConfigKV(BandConfigBuilder* b, const char* key,
                           const char* value);
BandConfig* BandConfigCreate(BandConfigBuilder* b);
BandConfig* BandConfigCreateFromFile(const char* json_path);
void BandConfigDelete(BandConfig* config);

/* -- model ------------------------------------------------------------- */
BandModel* BandModelCreate(void);
void BandModelDelete(BandModel* model);
BandStatus BandModelAddFromFile(BandModel* model, const char* model_path);
BandStatus BandModelAddFromBuffer(BandModel* model, const void* model_data,
                                  size_t model_size);

/* -- tensor (immutable shape; reference: band/c/c_api.h tensor getters) - */
typedef enum BandQuantizationType {
  kBandNoQuantization = 0,
  kBandAffineQuantization = 1,
} BandQuantizationType;

/* Affine quantization: real = scale * (q - zero_point); num_params is 1
 * for per-tensor quantization or C (along quantized_dimension) for
 * per-channel weights. Owned by the tensor; valid until
 * BandTensorDelete. */
typedef struct BandAffineQuantization {
  int num_params;
  const float* scales;
  const int* zero_points;
  int quantized_dimension;
} BandAffineQuantization;

void BandTensorDelete(BandTensor* tensor);
BandDataType BandTensorGetType(BandTensor* tensor);
void* BandTensorGetData(BandTensor* tensor);
size_t BandTensorGetNumDims(BandTensor* tensor);
const int* BandTensorGetDims(BandTensor* tensor);
size_t BandTensorGetBytes(BandTensor* tensor);
const char* BandTensorGetName(BandTensor* tensor);
BandQuantizationType BandTensorGetQuantizationType(BandTensor* tensor);
/* Returns a BandAffineQuantization* (as void*, matching the reference
 * signature: band/c/c_api.h:91) or NULL for unquantized tensors. */
void* BandTensorGetQuantizationParams(BandTensor* tensor);

/* -- request options ---------------------------------------------------- */
BandRequestOption BandRequestOptionGetDefault(void);

/* -- engine -------------------------------------------------------------- */
BandEngine* BandEngineCreate(BandConfig* config);
/* One GPU worker per visible CUDA card (at least one) plus a host worker,
 * fixed-worker scheduling (reference: BandEngineCreateWithDefaultConfig).
 * Without a card it returns NULL (BandGetLastError says why): the default
 * never serves on the host alone. */
BandEngine* BandEngineCreateWithDefaultConfig(void);
void BandEngineDelete(BandEngine* engine);
BandStatus BandEngineRegisterModel(BandEngine* engine, BandModel* model);
/* Extension beyond the reference C API: unregister a model (hot swap).
 * New requests fail immediately; queued jobs finish ENQUEUE_FAILED;
 * in-flight dispatches drain before teardown. */
BandStatus BandEngineUnregisterModel(BandEngine* engine, BandModel* model);
int BandEngineGetNumInputTensors(BandEngine* engine, BandModel* model);
int BandEngineGetNumOutputTensors(BandEngine* engine, BandModel* model);
int BandEngineGetNumWorkers(BandEngine* engine);
BandDeviceFlag BandEngineGetWorkerDevice(BandEngine* engine, int worker_id);

BandTensor* BandEngineCreateInputTensor(BandEngine* engine, BandModel* model,
                                        size_t index);
BandTensor* BandEngineCreateOutputTensor(BandEngine* engine, BandModel* model,
                                         size_t index);

BandStatus BandEngineRequestSync(BandEngine* engine, BandModel* model,
                                 BandTensor** input_tensors,
                                 BandTensor** output_tensors);
BandRequestHandle BandEngineRequestAsync(BandEngine* engine, BandModel* model,
                                         BandTensor** input_tensors);
BandStatus BandEngineRequestSyncOptions(BandEngine* engine, BandModel* model,
                                        BandRequestOption options,
                                        BandTensor** input_tensors,
                                        BandTensor** output_tensors);
BandRequestHandle BandEngineRequestAsyncOptions(BandEngine* engine,
                                                BandModel* model,
                                                BandRequestOption options,
                                                BandTensor** input_tensors);
/* Blocks until the job finishes and copies outputs into output_tensors
 * (pass num_outputs == 0 / output_tensors == NULL to just wait). */
BandStatus BandEngineWait(BandEngine* engine, BandRequestHandle handle,
                          BandTensor** output_tensors, size_t num_outputs);

/* End-of-request callback: fires on the planner thread for every finished
 * job with require_callback set. Returns a handle (>=0) or -1 on error. */
int BandEngineSetOnEndRequest(BandEngine* engine,
                              void (*on_end_invoke)(void* user_data,
                                                    int job_id,
                                                    BandStatus status),
                              void* user_data);
/* Unregister a callback previously returned by SetOnEndRequest. */
BandStatus BandEngineUnsetOnEndRequest(BandEngine* engine,
                                       int callback_handle);

/* -- buffer + image processor (reference: band/c/c_api_buffer.h) -------- */

/* User-provided image buffer; the library copies the pixel data, so the
 * caller's memory only needs to stay valid for the Set call. */
typedef struct BandBuffer BandBuffer;
/* A built pipeline of image operations converting a BandBuffer into a
 * model input BandTensor. An empty builder yields the automatic pipeline
 * (orientation fix + color convert + resize to the tensor's HxW + data
 * type convert), matching the reference default. */
typedef struct BandImageProcessor BandImageProcessor;
typedef struct BandImageProcessorBuilder BandImageProcessorBuilder;

/* Values match the reference's BandBufferFormat
 * (band/c/c_api_type.h:104-117). */
typedef enum BandBufferFormat {
  kBandGrayScale = 0,
  kBandRGB = 1,
  kBandRGBA = 2,
  kBandYV12 = 3,
  kBandYV21 = 4,
  kBandNV21 = 5,
  kBandNV12 = 6,
  kBandRaw = 7,
} BandBufferFormat;

/* Values match the reference's BandImageProcessorBuilderField
 * (band/c/c_api_type.h:178-186). */
typedef enum BandImageProcessorBuilderField {
  BAND_CROP = 0,
  BAND_RESIZE = 1,
  BAND_ROTATE = 2,
  BAND_FLIP = 3,
  BAND_COLOR_SPACE_CONVERT = 4,
  BAND_NORMALIZE = 5,
  BAND_DATA_TYPE_CONVERT = 6,
} BandImageProcessorBuilderField;

BandBuffer* BandBufferCreate(void);
void BandBufferDelete(BandBuffer* buffer);

/* Interleaved single-blob image data. GRAY/RGB/RGBA are w*h*channels
 * bytes; YUV 4:2:0 formats are the Y plane followed by the chroma
 * plane(s) in the format's memory order (NV12: interleaved UV; NV21:
 * interleaved VU; YV21/I420: U then V; YV12: V then U). */
BandStatus BandBufferSetFromRawData(BandBuffer* buffer, const void* data,
                                    size_t width, size_t height,
                                    BandBufferFormat format);

/* Explicit YUV 4:2:0 planes with strides. For NV12/NV21, u_data points at
 * the interleaved chroma plane and v_data is ignored (may be NULL). */
BandStatus BandBufferSetFromYUVData(BandBuffer* buffer, const void* y_data,
                                    const void* u_data, const void* v_data,
                                    size_t width, size_t height,
                                    size_t row_stride_y, size_t row_stride_uv,
                                    size_t pixel_stride_uv,
                                    BandBufferFormat buffer_format);

BandImageProcessorBuilder* BandImageProcessorBuilderCreate(void);
void BandImageProcessorBuilderDelete(BandImageProcessorBuilder* builder);
BandImageProcessor* BandImageProcessorBuilderBuild(
    BandImageProcessorBuilder* builder);

/* Append one operator. Variadic arguments per field (reference:
 * band/c/c_api_buffer.cc BandAddOperator):
 *   BAND_CROP               4 ints: x0, y0, x1, y1 (inclusive)
 *   BAND_RESIZE             2 ints: width, height
 *   BAND_ROTATE             1 int: counter-clockwise degrees (x90)
 *   BAND_FLIP               2 ints: horizontal, vertical (0/1)
 *   BAND_COLOR_SPACE_CONVERT 1 int: BandBufferFormat target
 *   BAND_NORMALIZE          2 doubles: mean, std
 *   BAND_DATA_TYPE_CONVERT  0 args (converts to the target tensor dtype)
 */
BandStatus BandAddOperator(BandImageProcessorBuilder* builder,
                           BandImageProcessorBuilderField field, int count,
                           ...);

/* Run the pipeline on buffer and write the result into target_tensor
 * (its dims/dtype define the target for the automatic pipeline and for
 * BAND_DATA_TYPE_CONVERT). */
BandStatus BandImageProcessorProcess(BandImageProcessor* image_processor,
                                     BandBuffer* buffer,
                                     BandTensor* target_tensor);
void BandImageProcessorDelete(BandImageProcessor* processor);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* BAND_TPU_TORCH_C_BAND_C_H_ */
