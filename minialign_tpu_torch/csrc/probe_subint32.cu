// P1: sub-int32 add / maximum / compare-gt / select, alone and in an
// 8-round loop carry, on (64, 128) int16 / int8 / uint8 arrays.
//
// Replaces tests/tools/probe_subint32.py:probe and :probe_carry (Pallas,
// TPU; there the question was which sub-int32 ops Mosaic legalizes) and
// is held against minialign_tpu_torch/probes/subint32.py:probe_plain and
// :probe_carry_plain, bit for bit.
//
// The kernel is probe_common.cuh:binop_kernel, one instantiation per
// (dtype, op): a thread loads 16 bytes of each operand (16 int8 / uint8
// or 8 int16 values), runs the op on packed lanes (__vadd4, __vmaxs4 /
// __vmaxu4, __vcmpgts4 / __vcmpgtu4; __vadd2, __vmaxs2, __vcmpgts2), and
// writes the result widened to int32 with 16-byte stores; misaligned
// inputs and the tail go one value at a time through the same lane ops.
// What bounds it: at the probe's 8,192 values and 48-64 KB the launch
// (a few microseconds), far above the bytes' 0.015-0.02 us; the design
// keeps the body to 512-1,024 threads of one load and a few stores each,
// in one-warp blocks spread over 16-32 SMs, so that the device time is
// the launch's and nothing else.

#include "probe_common.cuh"

extern "C" int p1_probe_launch(const void* x, const void* y, int n,
                               int dtype, int op, int rounds, void* out,
                               int device, void* stream) {
  return probe::binop_launch<int32_t>(x, y, n, dtype, op, rounds, out,
                                      device, stream);
}

// The probes' launch floor (probe_common.cuh:noop_launch): x, y, n,
// dtype, op and out are not read.
extern "C" int probe_noop_launch(const void* x, const void* y, int n,
                                 int dtype, int op, int launch, void* out,
                                 int device, void* stream) {
  return probe::noop_launch(launch, device, stream);
}
