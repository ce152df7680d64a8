"""The plain reference of the benchmark: TFLite's int8 kernels in exact
arithmetic, over a frozen flatbuffer reader.  It imports nothing of the
program under test (``band_tpu_torch``), of ``band_tpu`` or of JAX."""
