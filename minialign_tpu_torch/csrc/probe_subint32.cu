// P1: sub-int32 add / maximum / compare-gt / select, alone and in an
// 8-round loop carry, on (64, 128) int16 / int8 / uint8 arrays.
//
// Replaces tests/tools/probe_subint32.py:probe and :probe_carry (Pallas,
// TPU; there the question was which sub-int32 ops Mosaic legalizes) and
// is held against minialign_tpu_torch/probes/subint32.py:probe_plain and
// :probe_carry_plain, bit for bit.
//
// One thread per element (probe_common.cuh:binop_kernel), the result
// widened to int32. What bounds it: one launch and 48 KB of traffic at
// the probe's shape, i.e. the launch; there is nothing to tune.

#include "probe_common.cuh"

extern "C" int p1_probe_launch(const void* x, const void* y, int n,
                               int dtype, int op, int rounds, void* out,
                               void* stream) {
  return probe::binop_launch<int32_t>(x, y, n, dtype, op, rounds, out,
                                      stream);
}
