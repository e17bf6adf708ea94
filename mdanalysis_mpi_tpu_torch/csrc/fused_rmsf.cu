// Fused aligned-moments kernel for Hopper (sm_90a): dequant + per-frame
// COM and Kabsch correlation + QCP rotation + deviation moments over a
// planar (3, B, S) staged block, in one cooperative launch that reads the
// block from device memory once.
//
// Replaces the TPU kernel mdanalysis_mpi_tpu/ops/pallas_fused.py
// (_build_planar, pl.pallas_call at :289; rotation _qcp_rotation
// :78-212) and computes the same function: for every frame f of the
// block and atom s of the padded selection,
//
//   x       = q[:, f, s] * inv[f]                      (dequant)
//   com_f   = sum_s w[s] * x                           (w = masses / sum)
//   H_f     = sum_s x ref[s]^T - com_f (x) sref        (rank-1 fix-up)
//   R_f     = QCP rotation of H_f (40 Newton steps; aligned = x @ R)
//   dev     = ((x - com_f) @ R_f - ref[s]) * amask[s]
//   out[0:3, s] = sum_f fmask[f] * dev
//   out[3:6, s] = sum_f fmask[f] * dev^2
//
// Bound on the card: bytes.  The block read once, 3*B*S*sizeof(q), the
// per-atom arrays (w, ref, amask: 20 B an atom) and the (6, S) output
// written once: int16 at B = 512, S = 50,176 is 156.5 MB, 46.7 us at
// 3.35 TB/s; its ~63 operations per atom-frame take 24 us at the float32
// rate.
//
// Design.  One block per SM (blocks <= SM count, co-resident because
// the launch is cooperative), each owning a contiguous slice of atoms,
// a multiple of 16 (so every row of a slice is 16-byte aligned for int8,
// int16 and float32; the wrapper requires S % 256 == 0).  Frames go in
// groups of G through a ring of `stages` shared-memory stages, each
// (3, G, slice).  Each block has 15 warps with fixed roles, handing work
// over through mbarriers in shared memory and never through a block-wide
// barrier:
//   - loader (warp 13): one cp.async.bulk per row of the slice (3*G per
//     group) into the group's stage, completion on its mbarrier; a stage
//     is refilled once the moments warps have read it.  The staged block
//     crosses device memory once.
//   - sums (warps 1-6): two frames per warp, lanes over 4-atom chunks,
//     the 12 sums (sum w*q_i, sum q_i*ref_j) on the raw quantized values
//     (int16/int8 become exact floats by a 2^23 bias and a byte permute:
//     I2F runs at a quarter of the integer rate), w and ref of a slice of
//     up to 384 atoms held in registers; a transpose butterfly (16
//     shuffles for 12 values); each sum stored to part[(f*12+k)*blocks +
//     block].
//   - frame solver (warp 0): frame f is solved by block f % blocks.  It
//     reads the blocks' 12 partials of the frame (lane-strided, then a
//     fixed butterfly: block order never depends on timing), applies the
//     scale and the com (x) sref fix-up, runs qcp_rotation (its solve in
//     double) on one thread and stores the frame's record: R, com, scale,
//     fmask.
//   - rotations (warp 14): a group's records into one of four buffers in
//     shared memory.
//   - moments (warps 7-12): two atoms per thread; per group, once its
//     records are in, each atom's sum dev and sum dev^2 (accumulators in
//     shared memory) over the frames in order.  One write of (6, slice)
//     at the end, amask applied there.
// Cross-block exchange without flags: the wrapper fills part and the
// records with the bit pattern 0xffffffff, a NaN no arithmetic produces
// (stored NaNs are made canonical), and writers store each value with
// one relaxed 32-bit store; a reader polls the values themselves until
// none is unset.  One L2 round trip per hop, no fence on the compute
// warps.  Every sum has a fixed order (per atom: frames 0..B-1; per
// frame: chunks, butterflies, blocks in index order), so the output is
// bit-identical from run to run with no float atomics.
//
// Worked sizing (ops/fused_planar.fused_geometry), H100, 132 SMs, S =
// 50,176: slice 384 atoms, 131 blocks; int16 G = 12 (a stage is
// 3*12*384*2 = 27,648 B), int8 G = 24 and float32 G = 6 (the same
// bytes); 7 stages; 40 B an atom of parameters and accumulators: 212,480
// B of the 232,448 a block may use (int16).  Partials (B, 12, blocks):
// 3.2 MB, resident in L2.
//
// Wide mode.  Where even one frame a group in two stages does not fit a
// slice (above 4,448 atoms at int16, 5,024 at int8, 3,616 at float32: S
// above 587,008 / 663,040 / 477,184 atoms on 132 SMs), the same launch
// reads the block twice, a unit at a time through one ring of stages,
// with no per-atom area in shared memory:
//   - pass A, units (group g of 12 frames, chunk c of the slice) in the
//     order g, then c: warp w takes frame w and carries its 12 sums in
//     registers over the chunks, publishing them after the last as
//     above; the chunk's w and ref come with its frames.
//   - pass B, window by window of up to 512 frames: the compute warps
//     poll the window's records into a table in shared memory, then take
//     units (chunk c, group g), c then g; thread t carries the moments of
//     atoms 4t..4t+3 over the window's groups in registers and stores
//     them after the last (amask applied after the last window; between
//     windows the sums wait in `out`).
// The solver is the single-read form's; the rotations warp fills pass
// B's records table as the frames are solved, and the first chunk of a
// window waits for each group's records.
// Bound: bytes, as above, but the mode reads the block twice from device
// memory.  Its units are tensor-map boxes, one cp.async.bulk.tensor each
// (pass B: one a box row of at most 2,048 bytes, so 1-3), because a bulk
// copy costs its issuing thread ~50-75 ns whatever its length: a copy a
// row, 36-72 a unit, would hold the loader to 2.7-4.9 us a unit, longer
// than the unit's bytes take at the card's rate (~2 us;
// scripts/fused_rmsf_trace.py, its wide cases).  The block streams
// through L2 evict-first, w and ref evict-last.
// ops/fused_planar.fused_geometry sizes the units to fill a quarter of
// the room beside the records: S = 1,048,576 on 132 SMs, B = 512 gives
// slices of 7,952 atoms; pass A 12 frames of 512 / 896 / 256 atoms
// (int16 / int8 / float32) with w and ref, 37 / 32 / 37 KB of frames;
// pass B 6 / 12 / 3 frames of 1,344 / 1,328 / 1,344 atoms, 48 KB; four
// stages.
// Every sum keeps a fixed order (per atom: frames 0..B-1; per frame: the
// chunks in order, then the blocks), so the wide output is bit-identical
// from run to run too.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700.00 W):
// main shape, the median of 20 torch.profiler kernel events, 20 of 20
// recorded: int16 0.1319 ms, int8 0.1115; float32, the call with its
// scratch fill (CUDA events around each of 20 queued calls), 0.2032.
// The four-stage form it replaces, int16: its four kernels 0.2197 ms,
// the call 0.2284 (scripts/fused_rmsf_ab.py, same card).
// What holds it back is latency, not bytes (scripts/fused_rmsf_trace.py):
// a stage returns to the loader only after its group's rotations are
// in, and that cycle (copy, sums, the exchange, QCP ~5 us a frame on one
// thread, the exchange back, moments) takes ~20 us while the ring holds
// ~84 frames.  The wide mode at B = 512, S = 1,048,576 (the profiler
// median of 20 launches, scripts/fused_rmsf_ab.py, same card): int16
// 2.279 ms, int8 1.391-1.407, float32 4.290-4.293; one read's bound is
// 0.975 / 0.505 (operations) / 1.937 ms.  What holds it back
// (scripts/fused_rmsf_trace.py): at int16 and float32 the two reads, each
// unit streaming at 88-96% of 3.35 TB/s, and the blocks' skew; at int8
// pass B's instructions (~27 an atom-frame), 82% of its unit's time.

#include <cuda.h>           // CUtensorMap and its enums (no libcuda link:
                            // the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// Warp roles (see the header).
constexpr int kSolverWarp = 0;
constexpr int kSumWarps = 6;       // warps 1-6: per-frame sums
constexpr int kMomentWarps = 6;    // warps 7-12: per-atom moments
constexpr int kFirstSumWarp = 1;
constexpr int kFirstMomentWarp = kFirstSumWarp + kSumWarps;
constexpr int kComputeWarps = kSumWarps + kMomentWarps;
constexpr int kComputeThreads = kComputeWarps * 32;
constexpr int kMomentThreads = kMomentWarps * 32;
constexpr int kLoaderWarp = kFirstMomentWarp + kMomentWarps;
constexpr int kRotWarp = kLoaderWarp + 1;
constexpr int kThreads = kComputeThreads + 96;
constexpr int kRotBuffers = 4;     // groups of frame records in flight
// a slice of up to this many 4-atom chunks per lane keeps each compute
// lane's w and ref in registers for the sums (384 atoms)
constexpr int kRegChunks = 3;
constexpr int kNewtonIters = 40;
constexpr int kRot = 16;          // per frame: R (9), com (3), scale, fmask
constexpr int kMaxGroup = 24;
constexpr int kMaxStages = 12;
// wide mode: pass B's chunk, four atoms a compute thread; pass A's box
// rows, at most 256 eight-byte elements; the frames of records a block
// holds (pass B runs over windows of them)
constexpr int kWideChunkB = 4 * kComputeThreads;
constexpr int kBoxBytes = 2048;
constexpr int kWideRecords = 512;
constexpr int kMaxBlocks = 160;
constexpr int kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;
// The scratch is filled with this bit pattern before the launch: a NaN
// no arithmetic produces (the card's NaN is 0x7fffffff; stored NaNs are
// made canonical), so a reader polls each value until it differs.
constexpr unsigned kUnset = 0xffffffffu;
// a wait that lasts this many SM clocks (~20 s) traps instead of hanging
constexpr long long kSpinLimit = 40000000000LL;

struct Args {
  const void* qp;
  int B, S;
  const float* inv;
  float inv_scalar;
  const float* w;
  const float* ref;
  const float* amask;
  const float* fmask;
  const float* sref;
  int slice, blocks, group, stages;
  int chunk;          // wide mode: pass A's atoms a unit (0: single-read)
  float* part;        // (B, 12, blocks), kUnset on entry
  float* rot;         // (B, kRot), kUnset on entry
  float* out;         // (6, S)
  int group_b, chunk_b;  // wide mode: pass B's frames and atoms a unit
  int nbox_b;         // wide mode: pass B's boxes a unit (chunk_b / nbox_b
                      // atoms each)
  int records;        // wide mode: frames of records a window
  int stage_bytes;    // wide mode: bytes a stage (a multiple of 128)
};

// The wide mode's tensor maps: the (3, B, S) planes as 8-byte elements,
// boxes (chunk, group, 3) and (chunk_b / nbox_b, group_b, 3) in those
// elements.  A kernel parameter of its own, __grid_constant__ so that a
// copy reads it where it lies.
struct WideMaps {
  CUtensorMap a, b;
};

// Shared memory: mbarriers (512 B), kRotBuffers buffers of the frame
// records of a group (4 x G x 16 floats); then w, ref0, ref1, ref2 and
// the six accumulators (10 float planes of `slice`); then the ring of
// stages, each (3, G, slice) of T.  The wrapper sizes its geometry with
// the same count (fused_planar.fused_smem_bytes); this layout is the
// authority: the entry point refuses a geometry beyond kSmemMax.
__host__ __device__ inline int fixed_bytes(int group) {
  return 512 + group * kRotBuffers * kRot * 4;
}

__host__ __device__ inline long long smem_bytes(int slice, int group,
                                                int stages, int elem) {
  return fixed_bytes(group) + 40LL * slice +
         static_cast<long long>(stages) * 3 * group * slice * elem;
}

// The wide mode's layout: 512 B of barriers, the records of a window
// (records x 16 floats, to 128 B), then the ring of stages.  A stage holds
// one unit of either pass, each part at a 128-byte boundary: pass A's box
// (3, group, chunk) of T, then w (chunk floats) and ref (chunk x 3
// floats); or pass B's nbox_b boxes, each (3, group_b, chunk_b / nbox_b)
// of T.
__host__ __device__ inline long long round128(long long n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ inline long long wide_fixed_bytes(int records) {
  return 512 + round128(static_cast<long long>(records) * kRot * 4);
}

__host__ __device__ inline long long wide_box_b_bytes(int group_b,
                                                      int chunk_b,
                                                      int nbox_b, int elem) {
  return round128(3LL * group_b * (chunk_b / nbox_b) * elem);
}

__host__ __device__ inline long long wide_stage_bytes(int group, int chunk,
                                                      int group_b, int chunk_b,
                                                      int nbox_b, int elem) {
  const long long pass_a = 3LL * group * chunk * elem + 16LL * chunk;
  const long long pass_b =
      nbox_b * wide_box_b_bytes(group_b, chunk_b, nbox_b, elem);
  return round128(pass_a > pass_b ? pass_a : pass_b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kSpinLimit) __trap();
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Strong (relaxed, gpu scope) 32-bit accesses: each value is written
// once and read whole, never torn.
__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n"
               : "=f"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  // a NaN is stored as the card's own, never as kUnset
  const float c = v == v ? v : __int_as_float(0x7fffffff);
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(c)
               : "memory");
}

__device__ __forceinline__ bool unset(float v) {
  return __float_as_uint(v) == kUnset;
}

// Pause between polls; past ~20 s of SM clocks, trap instead of hanging.
__device__ __forceinline__ void poll_pause(long long t0) {
  if (clock64() - t0 > kSpinLimit) __trap();
  __nanosleep(20);
}

// Four consecutive elements → exact float32.  int16 and int8 take the
// 2^23 bias trick: the element, offset to unsigned, becomes the low
// mantissa bits of 2^23 (one byte permute), and one subtraction removes
// the bias (every integer below 2^24 is exact in float32).
__device__ __forceinline__ void load4(const int16_t* p, float v[4]) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  u.x ^= 0x80008000u;
  u.y ^= 0x80008000u;
  v[0] = __int_as_float(__byte_perm(u.x, 0x4B000000u, 0x7410)) - 8421376.0f;
  v[1] = __int_as_float(__byte_perm(u.x, 0x4B000000u, 0x7432)) - 8421376.0f;
  v[2] = __int_as_float(__byte_perm(u.y, 0x4B000000u, 0x7410)) - 8421376.0f;
  v[3] = __int_as_float(__byte_perm(u.y, 0x4B000000u, 0x7432)) - 8421376.0f;
}

__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  v[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  v[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  v[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  v[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// Two consecutive elements (an even index) → exact float32.
__device__ __forceinline__ void load2(const int16_t* p, float v[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80008000u;
  v[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7410)) - 8421376.0f;
  v[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7432)) - 8421376.0f;
}

__device__ __forceinline__ void load2(const int8_t* p, float v[2]) {
  const uint32_t u = static_cast<uint32_t>(
                         *reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
  v[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  v[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
}

__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  v[0] = u.x;
  v[1] = u.y;
}

// One round of the transpose butterfly below: lanes with bit `o` clear
// keep values [0, N) and send [N, 2N); the others keep [N, 2N) in
// slots [0, N) and send [0, N).
template <int N>
__device__ __forceinline__ void fold(float v[16], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

// Warp sum of 12 values, each lane's a[0..11]: a transpose butterfly
// (8 + 4 + 2 + 1 + 1 shuffles).  Lane l ends with the total of value
// (l >> 1) & 15 (values 12-15 are zero padding).
__device__ __forceinline__ float reduce12(const float a[12], int lane) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = a[k];
#pragma unroll
  for (int k = 12; k < 16; ++k) v[k] = 0.0f;
  fold<8>(v, lane, 16);
  fold<4>(v, lane, 8);
  fold<2>(v, lane, 4);
  fold<1>(v, lane, 2);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__device__ __forceinline__ double det3(double b00, double b01, double b02,
                                       double b10, double b11, double b12,
                                       double b20, double b21, double b22) {
  return b00 * (b11 * b22 - b12 * b21) - b01 * (b10 * b22 - b12 * b20) +
         b02 * (b10 * b21 - b11 * b20);
}

// QCP rotation (Theobald 2005) of the 3x3 correlation H (row-major,
// H = mobile^T ref): R row-major with aligned = mobile @ R.  The
// constants and the order of operations follow _qcp_rotation.  The
// normalisation and the quaternion's rotation run in float; the key
// matrix, the quartic, Newton and the adjugate in double: where the top
// eigenvalue of K is (nearly) double -- two atoms, or collinear ones --
// a float quartic loses the root and a float adjugate the eigenvector,
// and a two-atom selection's rotation misses the float64 Kabsch far
// beyond the kernel tests' tolerance (ROADMAP C5).  The plain version
// solves in double too.  Newton stops once a step is below 1e-15 of the
// root: a simple root is reached in a few steps (the TPU kernel always
// takes 40), a double one runs the 40.
__device__ void qcp_rotation(const float h_in[9], float r[9]) {
  // Frobenius-normalise: raw lambda^4-scale terms overflow float32
  const float trHH_raw = h_in[0] * h_in[0] + h_in[1] * h_in[1] +
                         h_in[2] * h_in[2] + h_in[3] * h_in[3] +
                         h_in[4] * h_in[4] + h_in[5] * h_in[5] +
                         h_in[6] * h_in[6] + h_in[7] * h_in[7] +
                         h_in[8] * h_in[8];
  const float fro = fmaxf(sqrtf(trHH_raw), 1e-30f);
  const float s = 1.0f / fro;
  const double h00 = h_in[0] * s, h01 = h_in[1] * s, h02 = h_in[2] * s;
  const double h10 = h_in[3] * s, h11 = h_in[4] * s, h12 = h_in[5] * s;
  const double h20 = h_in[6] * s, h21 = h_in[7] * s, h22 = h_in[8] * s;

  // key matrix K (4x4 symmetric)
  const double k00 = h00 + h11 + h22;
  const double k01 = h12 - h21;
  const double k02 = h20 - h02;
  const double k03 = h01 - h10;
  const double k11 = h00 - h11 - h22;
  const double k12 = h01 + h10;
  const double k13 = h20 + h02;
  const double k22 = -h00 + h11 - h22;
  const double k23 = h12 + h21;
  const double k33 = -h00 - h11 + h22;

  // characteristic quartic P(l) = l^4 + c2 l^2 + c1 l + c0
  const double trHH = h00 * h00 + h01 * h01 + h02 * h02 + h10 * h10 +
                      h11 * h11 + h12 * h12 + h20 * h20 + h21 * h21 +
                      h22 * h22;
  const double detH = h00 * (h11 * h22 - h12 * h21) -
                      h01 * (h10 * h22 - h12 * h20) +
                      h02 * (h10 * h21 - h11 * h20);
  const double c2 = -2.0 * trHH;
  const double c1 = -8.0 * detH;
  const double d0 = k11 * (k22 * k33 - k23 * k23) -
                    k12 * (k12 * k33 - k23 * k13) +
                    k13 * (k12 * k23 - k22 * k13);
  const double d1 = k01 * (k22 * k33 - k23 * k23) -
                    k12 * (k02 * k33 - k23 * k03) +
                    k13 * (k02 * k23 - k22 * k03);
  const double d2 = k01 * (k12 * k33 - k23 * k13) -
                    k11 * (k02 * k33 - k23 * k03) +
                    k13 * (k02 * k13 - k12 * k03);
  const double d3 = k01 * (k12 * k23 - k22 * k13) -
                    k11 * (k02 * k23 - k22 * k03) +
                    k12 * (k02 * k13 - k12 * k03);
  const double c0 = k00 * d0 - k01 * d1 + k02 * d2 - k03 * d3;

  // Newton from above: lambda_max <= sqrt(3 tr(H^T H))
  double lam = sqrt(3.0 * trHH) + 1e-6;
  for (int it = 0; it < kNewtonIters; ++it) {
    const double lam2 = lam * lam;
    const double p = lam2 * lam2 + c2 * lam2 + c1 * lam + c0;
    double dp = 4.0 * lam2 * lam + 2.0 * c2 * lam + c1;
    if (fabs(dp) < 1e-30) dp = 1e-30;
    const double step = p / dp;
    lam = lam - step;
    if (fabs(step) <= 1e-15 * lam) break;
  }

  // eigenvector of K at lambda: the max-norm row of adj(K - lambda I)
  const double a00 = k00 - lam, a11 = k11 - lam, a22 = k22 - lam,
               a33 = k33 - lam;
  const double a01 = k01, a02 = k02, a03 = k03, a12 = k12, a13 = k13,
               a23 = k23;
  double rows[4][4];
  rows[0][0] = det3(a11, a12, a13, a12, a22, a23, a13, a23, a33);
  rows[0][1] = -det3(a01, a12, a13, a02, a22, a23, a03, a23, a33);
  rows[0][2] = det3(a01, a11, a13, a02, a12, a23, a03, a13, a33);
  rows[0][3] = -det3(a01, a11, a12, a02, a12, a22, a03, a13, a23);
  rows[1][0] = -det3(a01, a02, a03, a12, a22, a23, a13, a23, a33);
  rows[1][1] = det3(a00, a02, a03, a02, a22, a23, a03, a23, a33);
  rows[1][2] = -det3(a00, a01, a03, a02, a12, a23, a03, a13, a33);
  rows[1][3] = det3(a00, a01, a02, a02, a12, a22, a03, a13, a23);
  rows[2][0] = det3(a01, a02, a03, a11, a12, a13, a13, a23, a33);
  rows[2][1] = -det3(a00, a02, a03, a01, a12, a13, a03, a23, a33);
  rows[2][2] = det3(a00, a01, a03, a01, a11, a13, a03, a13, a33);
  rows[2][3] = -det3(a00, a01, a02, a01, a11, a12, a03, a13, a23);
  rows[3][0] = -det3(a01, a02, a03, a11, a12, a13, a12, a22, a23);
  rows[3][1] = det3(a00, a02, a03, a01, a12, a13, a02, a22, a23);
  rows[3][2] = -det3(a00, a01, a03, a01, a11, a13, a02, a12, a23);
  rows[3][3] = det3(a00, a01, a02, a01, a11, a12, a02, a12, a22);

  double qa = rows[0][0], qb = rows[0][1], qc = rows[0][2], qd = rows[0][3];
  double nbest = qa * qa + qb * qb + qc * qc + qd * qd;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const double n = rows[i][0] * rows[i][0] + rows[i][1] * rows[i][1] +
                     rows[i][2] * rows[i][2] + rows[i][3] * rows[i][3];
    if (n > nbest) {
      qa = rows[i][0]; qb = rows[i][1]; qc = rows[i][2]; qd = rows[i][3];
    }
    nbest = fmax(nbest, n);
  }

  const double nrm = sqrt(fmax(nbest, 0.0));
  const bool degenerate = nrm < 1e-18;
  const double invn = degenerate ? 0.0 : 1.0 / fmax(nrm, 1e-30);
  const float qw = degenerate ? 1.0f : static_cast<float>(qa * invn);
  const float qx = static_cast<float>(qb * invn);
  const float qy = static_cast<float>(qc * invn);
  const float qz = static_cast<float>(qd * invn);

  // quaternion -> rotation, conjugate orientation (aligned = mobile @ R)
  r[0] = qw * qw + qx * qx - qy * qy - qz * qz;
  r[3] = 2.0f * (qx * qy - qw * qz);
  r[6] = 2.0f * (qx * qz + qw * qy);
  r[1] = 2.0f * (qx * qy + qw * qz);
  r[4] = qw * qw - qx * qx + qy * qy - qz * qz;
  r[7] = 2.0f * (qy * qz - qw * qx);
  r[2] = 2.0f * (qx * qz - qw * qy);
  r[5] = 2.0f * (qy * qz + qw * qx);
  r[8] = qw * qw - qx * qx - qy * qy + qz * qz;
}

// The 12 sums of one frame (planes x0, x1, x2) over one 4-atom chunk
// j: p holds the chunk's w, ref0, ref1, ref2 (4 each).
template <typename T>
__device__ __forceinline__ void chunk_sums(const T* x0, const T* x1,
                                           const T* x2, int j,
                                           const float p[16], float s[12]) {
  float q0[4], q1[4], q2[4];
  load4(x0 + 4 * j, q0);
  load4(x1 + 4 * j, q1);
  load4(x2 + 4 * j, q2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float w = p[e], r0 = p[4 + e], r1 = p[8 + e], r2 = p[12 + e];
    s[0] += w * q0[e];
    s[1] += w * q1[e];
    s[2] += w * q2[e];
    s[3] += q0[e] * r0;
    s[4] += q0[e] * r1;
    s[5] += q0[e] * r2;
    s[6] += q1[e] * r0;
    s[7] += q1[e] * r1;
    s[8] += q1[e] * r2;
    s[9] += q2[e] * r0;
    s[10] += q2[e] * r1;
    s[11] += q2[e] * r2;
  }
}

// The loader warp: copy group g's rows of this block's slice into its
// stage (one bulk copy per row, spread over the lanes).
template <typename T>
__device__ __forceinline__ void copy_group(const Args& a, T* ring,
                                            uint64_t* full, int g, int s0,
                                            int ns, int lane) {
  const int G = a.group;
  const int st = g % a.stages;
  const int f0 = g * G;
  const int gf = min(G, a.B - f0);
  const uint32_t bytes = static_cast<uint32_t>(ns) * sizeof(T);
  T* base = ring + static_cast<size_t>(st) * 3 * G * a.slice;
  // the stage was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) mbar_expect_tx(&full[st], 3u * gf * bytes);
  __syncwarp();
  const T* qp = static_cast<const T*>(a.qp);
  for (int k = lane; k < 3 * gf; k += 32) {
    const int c = k >= 2 * gf ? 2 : (k >= gf ? 1 : 0);
    const int f = k - c * gf;
    const T* src = qp + (static_cast<size_t>(c) * a.B + f0 + f) * a.S + s0;
    bulk_copy(base + (static_cast<size_t>(c) * G + f) * a.slice, src, bytes,
              &full[st]);
  }
}

// Lane 0 of a warp arrives on an mbarrier once all its lanes are done.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// A group's frame records (gf frames of kRot floats at src; 14 used of
// 16) into shared memory at dst, every field of every frame in one pass,
// polled value by value until none is unset.
__device__ __forceinline__ void load_records(const float* src, float* dst,
                                             int gf, int lane) {
  const long long t0 = clock64();
  constexpr int kPer = kMaxGroup * kRot / 32;
  float v[kPer];
  for (;;) {
    bool miss = false;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = lane + 32 * r;
      const bool used = i < gf * kRot && (i & (kRot - 1)) < 14;
      v[r] = used ? ld_relaxed(src + i) : 0.0f;
      miss |= used && unset(v[r]);
    }
    if (!__any_sync(kFull, miss)) break;
    poll_pause(t0);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + 32 * r;
    if (i < gf * kRot) dst[i] = v[r];
  }
}

// The moments of two atoms over the gf frames of a group in a stage: x0
// is the atoms' first component in frame 0, rows of `row` elements, G
// frames a component; fr4 the group's records (R, com, scale, fmask).
template <typename T>
__device__ __forceinline__ void add_frames(const float4* fr4, const T* x0,
                                           int gf, int G, int row,
                                           const float r[2][3],
                                           float sd[2][3], float sq[2][3]) {
#pragma unroll 2
  for (int f = 0; f < gf; ++f) {
    const float4 A = fr4[f * 4];        // R00 R01 R02 R10
    const float4 Bq = fr4[f * 4 + 1];   // R11 R12 R20 R21
    const float4 C = fr4[f * 4 + 2];    // R22 com0 com1 com2
    const float4 D = fr4[f * 4 + 3];    // scale fmask
    const T* xf = x0 + static_cast<size_t>(f) * row;
    float q0[2], q1[2], q2[2];
    load2(xf, q0);
    load2(xf + static_cast<size_t>(G) * row, q1);
    load2(xf + static_cast<size_t>(2 * G) * row, q2);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xc0 = fmaf(q0[e], D.x, -C.y);
      const float xc1 = fmaf(q1[e], D.x, -C.z);
      const float xc2 = fmaf(q2[e], D.x, -C.w);
      // (xc @ R)_j - ref_j, the reference folded into the chain
      const float dev0 =
          fmaf(xc2, Bq.z, fmaf(xc1, A.w, fmaf(xc0, A.x, -r[e][0])));
      const float dev1 =
          fmaf(xc2, Bq.w, fmaf(xc1, Bq.x, fmaf(xc0, A.y, -r[e][1])));
      const float dev2 =
          fmaf(xc2, C.x, fmaf(xc1, Bq.y, fmaf(xc0, A.z, -r[e][2])));
      const float dm0 = dev0 * D.y;
      const float dm1 = dev1 * D.y;
      const float dm2 = dev2 * D.y;
      sd[e][0] += dm0;
      sd[e][1] += dm1;
      sd[e][2] += dm2;
      sq[e][0] += dm0 * dev0;
      sq[e][1] += dm1 * dev1;
      sq[e][2] += dm2 * dev2;
    }
  }
}

// ---- the wide mode (see the header)

// L2 eviction policies of the copies: the staged block streams through
// once a pass (evict first); w and ref are read again every group (evict
// last).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One box of a (3, B, S) tensor map, from element x of a row and frame y
// of component 0, into shared memory at dst; completion on bar.  Parts of
// the box past the tensor arrive as zeros and count.
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(0),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// A block's units, in the order the loader fills the ring and the compute
// warps read it: pass A's (group g, chunk c), g then c; then, window by
// window of records, pass B's (chunk c, group g), c then g.
struct WideShape {
  int ng;    // pass A's groups
  int nc;    // pass A's chunks of the slice
  int nw;    // pass B's windows of records
  int ncb;   // pass B's chunks of the slice
};

__device__ __forceinline__ WideShape wide_shape(const Args& a, int ns) {
  WideShape w;
  w.ng = (a.B + a.group - 1) / a.group;
  w.nc = (ns + a.chunk - 1) / a.chunk;
  w.nw = (a.B + a.records - 1) / a.records;
  w.ncb = (ns + a.chunk_b - 1) / a.chunk_b;
  return w;
}

__device__ __forceinline__ int window_frames(const Args& a, int w) {
  return min(a.records, a.B - w * a.records);
}

// Unit u's stage, once the compute warps have read the unit before it in
// that stage.
__device__ __forceinline__ int wide_acquire(uint64_t* empty, int u,
                                            int nst) {
  const int st = u % nst;
  if (u >= nst) mbar_wait(&empty[st], ((u - nst) / nst) & 1);
  // the stage was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  return st;
}

// The loader, one thread: each unit's stage filled by one box copy and
// the chunk's w and ref by two bulk copies (pass A), or by the chunk's
// boxes (pass B).
template <typename T>
__device__ __forceinline__ void wide_loader(const Args& a,
                                            const WideMaps& maps,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int s0, int ns) {
  const WideShape sh = wide_shape(a, ns);
  const int nst = a.stages;
  const uint64_t stream = l2_evict_first();
  const uint64_t keep = l2_evict_last();
  constexpr int kElem = 8 / sizeof(T);   // atoms an 8-byte element
  const uint32_t box_a = 3u * a.group * a.chunk * sizeof(T);
  int u = 0;
  for (int g = 0; g < sh.ng; ++g) {
    for (int c = 0; c < sh.nc; ++c, ++u) {
      const int st = wide_acquire(empty, u, nst);
      unsigned char* base = ring + static_cast<size_t>(st) * a.stage_bytes;
      const int c0 = s0 + c * a.chunk;
      const uint32_t n = min(a.chunk, ns - c * a.chunk);
      mbar_expect_tx(&full[st], box_a + 16u * n);
      box_copy(base, &maps.a, c0 / kElem, g * a.group, &full[st], stream);
      float* pw = reinterpret_cast<float*>(base + box_a);
      bulk_copy_hint(pw, a.w + c0, 4u * n, &full[st], keep);
      bulk_copy_hint(pw + a.chunk, a.ref + 3 * static_cast<size_t>(c0),
                     12u * n, &full[st], keep);
    }
  }
  const int per_box = a.chunk_b / a.nbox_b;
  const uint32_t box_b = 3u * a.group_b * per_box * sizeof(T);
  const size_t slot =
      wide_box_b_bytes(a.group_b, a.chunk_b, a.nbox_b, sizeof(T));
  for (int w = 0; w < sh.nw; ++w) {
    const int ngw = (window_frames(a, w) + a.group_b - 1) / a.group_b;
    for (int c = 0; c < sh.ncb; ++c) {
      const int c0 = s0 + c * a.chunk_b;
      const int n = min(a.chunk_b, ns - c * a.chunk_b);
      const int nbox = (n + per_box - 1) / per_box;   // boxes with atoms
      for (int g = 0; g < ngw; ++g, ++u) {
        const int st = wide_acquire(empty, u, nst);
        unsigned char* base = ring + static_cast<size_t>(st) * a.stage_bytes;
        mbar_expect_tx(&full[st], nbox * box_b);
        for (int k = 0; k < nbox; ++k)
          box_copy(base + k * slot, &maps.b, (c0 + k * per_box) / kElem,
                   w * a.records + g * a.group_b, &full[st], stream);
      }
    }
  }
}

// The rotations warp: window by window, the records into the table in
// batches of up to kMaxGroup frames as the solvers store them (polled),
// each batch announced by the frame count in `rprog`; a window's table is
// refilled once the compute warps have read the one before (`tfree`).
__device__ __forceinline__ void wide_records(const Args& a, float* table,
                                             volatile int* rprog,
                                             uint64_t* tfree, int lane) {
  const int nw = (a.B + a.records - 1) / a.records;
  for (int w = 0; w < nw; ++w) {
    if (w > 0) mbar_wait(tfree, (w - 1) & 1);
    const int f0 = w * a.records;
    const int nf = window_frames(a, w);
    for (int f = 0; f < nf; f += kMaxGroup) {
      const int gf = min(kMaxGroup, nf - f);
      load_records(a.rot + static_cast<size_t>(f0 + f) * kRot,
                   table + f * kRot, gf, lane);
      __syncwarp();
      __threadfence_block();
      if (lane == 0) *rprog = f0 + f + gf;
    }
  }
}

// (xc @ R)_j - ref_j of one atom of a frame whose record is A, Bq, C
// (R row-major, then com) and scale sc: the centred coordinates, the
// rotation and the reference folded into one chain (add_frames' order).
__device__ __forceinline__ void deviation(float q0, float q1, float q2,
                                          float4 A, float4 Bq, float4 C,
                                          float sc, const float r[3],
                                          float dev[3]) {
  const float xc0 = fmaf(q0, sc, -C.y);
  const float xc1 = fmaf(q1, sc, -C.z);
  const float xc2 = fmaf(q2, sc, -C.w);
  dev[0] = fmaf(xc2, Bq.z, fmaf(xc1, A.w, fmaf(xc0, A.x, -r[0])));
  dev[1] = fmaf(xc2, Bq.w, fmaf(xc1, Bq.x, fmaf(xc0, A.y, -r[1])));
  dev[2] = fmaf(xc2, C.x, fmaf(xc1, Bq.y, fmaf(xc0, A.z, -r[2])));
}

// The moments of four atoms over the gf frames of a pass-B box: x0 is the
// atoms' first component in frame 0, rows of `row` elements, `plane`
// elements a component; fr4 the frames' records (R, com, scale, fmask).
// A frame of weight 1 (the frame mask's common case) skips the product
// by the weight: dev * 1 is dev, bit for bit.
template <typename T>
__device__ __forceinline__ void moments4(const float4* fr4, const T* x0,
                                         int gf, int row, int plane,
                                         const float r[4][3], float sd[4][3],
                                         float sq[4][3]) {
#pragma unroll 2
  for (int f = 0; f < gf; ++f) {
    const float4 A = fr4[f * 4];        // R00 R01 R02 R10
    const float4 Bq = fr4[f * 4 + 1];   // R11 R12 R20 R21
    const float4 C = fr4[f * 4 + 2];    // R22 com0 com1 com2
    const float4 D = fr4[f * 4 + 3];    // scale fmask
    const T* xf = x0 + f * row;
    float q0[4], q1[4], q2[4];
    load4(xf, q0);
    load4(xf + plane, q1);
    load4(xf + 2 * plane, q2);
    if (D.y == 1.0f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dev[3];
        deviation(q0[e], q1[e], q2[e], A, Bq, C, D.x, r[e], dev);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sd[e][j] += dev[j];
          sq[e][j] += dev[j] * dev[j];
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dev[3];
        deviation(q0[e], q1[e], q2[e], A, Bq, C, D.x, r[e], dev);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float dm = dev[j] * D.y;
          sd[e][j] += dm;
          sq[e][j] += dm * dev[j];
        }
      }
    }
  }
}

// The 12 compute warps (w = warp - 1): pass A, then pass B.
template <typename T>
__device__ __forceinline__ void wide_compute(
    const Args& a, const unsigned char* ring, const float* table,
    uint64_t* full, uint64_t* empty, volatile int* sprog,
    volatile int* rprog, uint64_t* tfree, int s0, int ns, int warp,
    int lane) {
  const WideShape sh = wide_shape(a, ns);
  const int G = a.group;
  const int ck = a.chunk;
  const int nst = a.stages;
  const int nblk = a.blocks;
  const int w = warp - kFirstSumWarp;
  const int plane = G * ck;
  int u = 0;

  // ---- pass A: frame w of each group (one a compute warp), lanes over
  // the chunk's 4-atom runs with w and ref from the stage; the frame's 12
  // sums carried over the chunks in registers and published after the
  // last
  for (int g = 0; g < sh.ng; ++g) {
    const int gf = min(G, a.B - g * G);
    float sa[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) sa[k] = 0.0f;
    for (int c = 0; c < sh.nc; ++c, ++u) {
      const int st = u % nst;
      mbar_wait(&full[st], (u / nst) & 1);
      const unsigned char* base = ring + static_cast<size_t>(st) * a.stage_bytes;
      const T* x = reinterpret_cast<const T*>(base);
      const float4* pw =
          reinterpret_cast<const float4*>(base + 3 * plane * sizeof(T));
      const float4* pr = pw + ck / 4;   // ref, 12 floats a 4-atom run
      const int nch = min(ck, ns - c * ck) / 4;
      if (w < gf) {
        const T* xa = x + w * ck;
        for (int j = lane; j < nch; j += 32) {
          const float4 wv = pw[j];
          const float4 r0 = pr[3 * j], r1 = pr[3 * j + 1], r2 = pr[3 * j + 2];
          const float p[16] = {wv.x, wv.y, wv.z, wv.w,
                               r0.x, r0.w, r1.z, r2.y,
                               r0.y, r1.x, r1.w, r2.z,
                               r0.z, r1.y, r2.x, r2.w};
          chunk_sums(xa, xa + plane, xa + 2 * plane, j, p, sa);
        }
      }
      warp_arrive(&empty[st], lane);
    }
    const int k = (lane >> 1) & 15;
    if (w < gf) {
      const float v = reduce12(sa, lane);
      if ((lane & 1) == 0 && k < 12)
        st_relaxed(a.part + ((static_cast<size_t>(g) * G + w) * 12 + k) *
                                nblk + blockIdx.x,
                   v);
    }
    // the frame solver's hint reads the first kSumWarps warps
    if (lane == 0 && w < kSumWarps) sprog[w] = g + 1;
  }

  // ---- pass B: window by window of records, atoms i..i+3 of each chunk,
  // their moments carried over the window's groups in registers and
  // stored after its last (amask applied after the last window); the
  // first chunk of a window waits for each group's records
  const int ct = threadIdx.x - kFirstSumWarp * 32;
  const int i = 4 * ct;
  const int per_box = a.chunk_b / a.nbox_b;
  const int kb = i / per_box;                     // the box of the atoms
  const size_t slot =
      wide_box_b_bytes(a.group_b, a.chunk_b, a.nbox_b, sizeof(T));
  const int plane_b = a.group_b * per_box;
  const size_t S = a.S;
  for (int wi = 0; wi < sh.nw; ++wi) {
    const int nf = window_frames(a, wi);
    const int ngw = (nf + a.group_b - 1) / a.group_b;
    const bool last = wi == sh.nw - 1;
    for (int c = 0; c < sh.ncb; ++c) {
      const bool mine = i < min(a.chunk_b, ns - c * a.chunk_b);
      const size_t s = static_cast<size_t>(s0) + c * a.chunk_b + i;
      float sd[4][3], sq[4][3], r[4][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          sd[e][q] = 0.0f;
          sq[e][q] = 0.0f;
          r[e][q] = 0.0f;
        }
      }
      if (mine) {
        const float4* rp = reinterpret_cast<const float4*>(a.ref + 3 * s);
        const float4 v0 = __ldg(rp), v1 = __ldg(rp + 1), v2 = __ldg(rp + 2);
        const float rv[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                              v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int q = 0; q < 3; ++q) r[e][q] = rv[3 * e + q];
        }
        if (wi > 0) {
          // the sums of the windows before, as stored after the last
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float4 d = *reinterpret_cast<const float4*>(a.out + q * S + s);
            const float4 e2 =
                *reinterpret_cast<const float4*>(a.out + (3 + q) * S + s);
            sd[0][q] = d.x; sd[1][q] = d.y; sd[2][q] = d.z; sd[3][q] = d.w;
            sq[0][q] = e2.x; sq[1][q] = e2.y; sq[2][q] = e2.z; sq[3][q] = e2.w;
          }
        }
      }
      for (int g = 0; g < ngw; ++g, ++u) {
        const int st = u % nst;
        mbar_wait(&full[st], (u / nst) & 1);
        if (c == 0) {
          const int need = wi * a.records + min((g + 1) * a.group_b, nf);
          if (lane == 0) {
            const long long t0 = clock64();
            while (*rprog < need) poll_pause(t0);
            __threadfence_block();
          }
          __syncwarp();
        }
        if (mine)
          moments4(reinterpret_cast<const float4*>(
                       table + static_cast<size_t>(g) * a.group_b * kRot),
                   reinterpret_cast<const T*>(
                       ring + static_cast<size_t>(st) * a.stage_bytes +
                       kb * slot) + (i - kb * per_box),
                   min(a.group_b, nf - g * a.group_b), per_box, plane_b, r,
                   sd, sq);
        warp_arrive(&empty[st], lane);
      }
      if (mine) {
        float4 am = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        if (last) am = __ldg(reinterpret_cast<const float4*>(a.amask + s));
        const float m[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float d[4], e2[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[e] = last ? sd[e][q] * m[e] : sd[e][q];
            e2[e] = last ? sq[e][q] * (m[e] * m[e]) : sq[e][q];
          }
          *reinterpret_cast<float4*>(a.out + q * S + s) =
              make_float4(d[0], d[1], d[2], d[3]);
          *reinterpret_cast<float4*>(a.out + (3 + q) * S + s) =
              make_float4(e2[0], e2[1], e2[2], e2[3]);
        }
      }
    }
    warp_arrive(tfree, lane);   // the window's table is read
  }
}

// The kernel; its warps' roles are described at the top of the file.
// kWide selects the wide mode (a.chunk > 0).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
fused_planar_kernel(const Args a, const __grid_constant__ WideMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.group;
  const int slice = a.slice;
  const int nblk = a.blocks;
  const int NST = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // data landed
  uint64_t* empty = full + kMaxStages;                  // stage read
  uint64_t* rfull = empty + kMaxStages;                 // rotations in
  uint64_t* rempty = rfull + kRotBuffers;               // rotations used
  volatile int* sprog =                                 // sums done
      reinterpret_cast<volatile int*>(rempty + kRotBuffers);
  float* frot = reinterpret_cast<float*>(smem + 512);   // 4 x G x kRot
  float* pw = reinterpret_cast<float*>(smem + fixed_bytes(G));
  float* acc = pw + 4 * slice;
  T* ring = reinterpret_cast<T*>(acc + 6 * slice);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int blk = blockIdx.x;
  const int s0 = blk * slice;
  const int ns = min(slice, a.S - s0);
  const int ng = (a.B + G - 1) / G;
  // the warps that release a stage and a records buffer
  constexpr int kReaders = kWide ? kComputeWarps : kMomentWarps;

  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kReaders);
    }
    for (int i = 0; i < kRotBuffers; ++i) {
      mbar_init(&rfull[i], 1);
      mbar_init(&rempty[i], kReaders);
    }
    for (int i = 0; i < kSumWarps; ++i) sprog[i] = 0;
    if constexpr (kWide) sprog[kSumWarps] = 0;   // records in (rprog)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kWide) {
    for (int i = tid; i < ns; i += kThreads) {
      const int s = s0 + i;
      pw[i] = __ldg(a.w + s);
      pw[slice + i] = __ldg(a.ref + 3 * s);
      pw[2 * slice + i] = __ldg(a.ref + 3 * s + 1);
      pw[3 * slice + i] = __ldg(a.ref + 3 * s + 2);
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[k * slice + i] = 0.0f;
    }
  }
  __syncthreads();   // the last block-wide barrier: roles split here

  if constexpr (kWide) {
    // the wide mode's roles; its frame solver is the one below.  Its
    // layout: the records table after the barriers, then the ring; the
    // table's progress after the sums' (rprog), its release on rempty[0]
    unsigned char* wring = smem + wide_fixed_bytes(a.records);
    volatile int* rprog = sprog + kSumWarps;
    if (warp == kLoaderWarp) {
      if (lane == 0) wide_loader<T>(a, maps, wring, full, empty, s0, ns);
      return;
    }
    if (warp == kRotWarp) {
      wide_records(a, frot, rprog, &rempty[0], lane);
      return;
    }
    if (warp != kSolverWarp) {
      wide_compute<T>(a, wring, frot, full, empty, sprog, rprog, &rempty[0],
                      s0, ns, warp, lane);
      return;
    }
  }

  if (warp == kLoaderWarp) {
    // ---- loader: the first stages, then the refill of group r's stage
    // with group r + NST once the moments warps have read it (the sums
    // warps have: its rotations needed every block's sums)
    for (int g = 0; g < min(NST, ng); ++g)
      copy_group(a, ring, full, g, s0, ns, lane);
    for (int r = 0; r + NST < ng; ++r) {
      mbar_wait(&empty[r % NST], (r / NST) & 1);
      copy_group(a, ring, full, r + NST, s0, ns, lane);
    }
    return;
  }

  if (warp == kRotWarp) {
    // ---- rotations: group m's frame records into shared memory, once
    // every frame's is written (polled value by value) and the buffer is
    // free
    for (int m = 0; m < ng; ++m) {
      const int b = m % kRotBuffers;
      if (m >= kRotBuffers)
        mbar_wait(&rempty[b], ((m - kRotBuffers) / kRotBuffers) & 1);
      const int gf = min(G, a.B - m * G);
      load_records(a.rot + static_cast<size_t>(m) * G * kRot,
                   frot + b * G * kRot, gf, lane);
      warp_arrive(&rfull[b], lane);
    }
    return;
  }

  if (warp == kSolverWarp) {
    // ---- solver: the frames f = blk, blk + blocks, ...: the blocks'
    // partials of the 12 sums in block order, the scale, the com (x) sref
    // fix-up, QCP; then the frame's record
    for (int f = blk; f < a.B; f += nblk) {
      const int g = f / G;
      const float* src = a.part + static_cast<size_t>(f) * 12 * nblk;
      const long long t0 = clock64();
      // this block's own sums of group g first (a hint in shared memory:
      // the other blocks' come about as late), then every block's
      while (lane < kSumWarps && sprog[lane] <= g) poll_pause(t0);
      __syncwarp();
      float t[kMaxBlocks / 32][12];
      for (;;) {
        bool miss = false;
#pragma unroll
        for (int i = 0; i < kMaxBlocks / 32; ++i) {
          const int b = lane + 32 * i;
#pragma unroll
          for (int k = 0; k < 12; ++k) {
            t[i][k] = b < nblk ? ld_relaxed(src + k * nblk + b) : 0.0f;
            miss |= unset(t[i][k]);
          }
        }
        if (!__any_sync(kFull, miss)) break;
        poll_pause(t0);
      }
      float v[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        v[k] = t[0][k];
#pragma unroll
        for (int i = 1; i < kMaxBlocks / 32; ++i) v[k] += t[i][k];
      }
      const float tot = reduce12(v, lane);   // lane 2k holds sum k
      float sm[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) sm[k] = __shfl_sync(kFull, tot, 2 * k);
      if (lane == 0) {
        const float sc = a.inv != nullptr ? __ldg(a.inv + f) : a.inv_scalar;
        const float com[3] = {sm[0] * sc, sm[1] * sc, sm[2] * sc};
        float h[9];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            h[i * 3 + j] = sm[3 + i * 3 + j] * sc - com[i] * __ldg(a.sref + j);
        }
        float r[9];
        qcp_rotation(h, r);
        float* o = a.rot + static_cast<size_t>(f) * kRot;
#pragma unroll
        for (int k = 0; k < 9; ++k) st_relaxed(o + k, r[k]);
        st_relaxed(o + 9, com[0]);
        st_relaxed(o + 10, com[1]);
        st_relaxed(o + 11, com[2]);
        st_relaxed(o + 12, sc);
        st_relaxed(o + 13, __ldg(a.fmask + f));
      }
      __syncwarp();
    }
    return;
  }

  if (warp < kFirstMomentWarp) {
    const int sw = warp - kFirstSumWarp;
    // ---- sums: warp w takes frames w, w + 6, ... of each group, two
    // at a time, lanes over the slice's 4-atom chunks; the block's sums
    // of a group are signalled to the publisher
    const int nch = ns / 4;
    const bool preg = nch <= 32 * kRegChunks;
    float pr[kRegChunks][16];   // w, ref0, ref1, ref2 of the lane's chunks
#pragma unroll
    for (int c = 0; c < kRegChunks; ++c) {
      const int j = lane + 32 * c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (preg && j < nch) {
          load4(pw + q * slice + 4 * j, pr[c] + 4 * q);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[c][4 * q + e] = 0.0f;
        }
      }
    }
    const size_t plane = static_cast<size_t>(G) * slice;
    for (int g = 0; g < ng; ++g) {
      const int st = g % NST;
      mbar_wait(&full[st], (g / NST) & 1);
      const T* base = ring + static_cast<size_t>(st) * 3 * plane;
      const int gf = min(G, a.B - g * G);
      for (int fa = sw; fa < gf; fa += 2 * kSumWarps) {
        const int fb = fa + kSumWarps;
        const bool two = fb < gf;
        const T* a0 = base + static_cast<size_t>(fa) * slice;
        const T* b0 = base + static_cast<size_t>(two ? fb : fa) * slice;
        float sa[12], sb[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          sa[k] = 0.0f;
          sb[k] = 0.0f;
        }
        if (preg) {
#pragma unroll
          for (int c = 0; c < kRegChunks; ++c) {
            const int j = lane + 32 * c;
            if (j < nch) {
              chunk_sums(a0, a0 + plane, a0 + 2 * plane, j, pr[c], sa);
              if (two)
                chunk_sums(b0, b0 + plane, b0 + 2 * plane, j, pr[c], sb);
            }
          }
        } else {
          for (int j = lane; j < nch; j += 32) {
            float p[16];
#pragma unroll
            for (int q = 0; q < 4; ++q) load4(pw + q * slice + 4 * j, p + 4 * q);
            chunk_sums(a0, a0 + plane, a0 + 2 * plane, j, p, sa);
            if (two) chunk_sums(b0, b0 + plane, b0 + 2 * plane, j, p, sb);
          }
        }
        const int k = (lane >> 1) & 15;
        const bool writer = (lane & 1) == 0 && k < 12;
        const float va = reduce12(sa, lane);
        if (writer) {
          const size_t f = static_cast<size_t>(g) * G + fa;
          st_relaxed(a.part + (f * 12 + k) * nblk + blk, va);
        }
        if (two) {
          const float vb = reduce12(sb, lane);
          if (writer) {
            const size_t f = static_cast<size_t>(g) * G + fb;
            st_relaxed(a.part + (f * 12 + k) * nblk + blk, vb);
          }
        }
      }
      // progress hint for the frame solver
      if (lane == 0) sprog[sw] = g + 1;
    }
    return;
  }

  // ---- moments: thread t of warps 6-11 takes the atom pairs (2p, 2p+1)
  // for p = t, t + 192, ...; each group once its rotations are in, frames
  // in order; then the group's stage and rotation buffer are released
  const int mt = tid - kFirstMomentWarp * 32;
  for (int m = 0; m < ng; ++m) {
    const int st = m % NST;
    const int b = m % kRotBuffers;
    mbar_wait(&full[st], (m / NST) & 1);
    mbar_wait(&rfull[b], (m / kRotBuffers) & 1);
    const int gf = min(G, a.B - m * G);
    const T* base = ring + static_cast<size_t>(st) * 3 * G * slice;
    const float4* fr4 = reinterpret_cast<const float4*>(frot + b * G * kRot);
    for (int i = 2 * mt; i < ns; i += 2 * kMomentThreads) {
      float sd[2][3], sq[2][3], r[2][3];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sd[e][c] = acc[c * slice + i + e];
          sq[e][c] = acc[(3 + c) * slice + i + e];
          r[e][c] = pw[(1 + c) * slice + i + e];
        }
      }
      add_frames(fr4, base + i, gf, G, slice, r, sd, sq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[c * slice + i + e] = sd[e][c];
          acc[(3 + c) * slice + i + e] = sq[e][c];
        }
      }
    }
    warp_arrive(&empty[st], lane);
    warp_arrive(&rempty[b], lane);
  }

  // ---- one write of (6, slice), amask applied (each thread its atoms)
  for (int i = 2 * mt; i < ns; i += 2 * kMomentThreads) {
#pragma unroll
   for (int e = 0; e < 2; ++e) {
    const size_t s = static_cast<size_t>(s0) + i + e;
    const float am = __ldg(a.amask + s);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a.out[k * static_cast<size_t>(a.S) + s] = acc[k * slice + i + e] * am;
#pragma unroll
    for (int k = 3; k < 6; ++k)
      a.out[k * static_cast<size_t>(a.S) + s] =
          acc[k * slice + i + e] * (am * am);
   }
  }
}

// The kernel's dynamic shared-memory ceiling, raised once per element
// type and process to the card's limit: a host call, so it never runs
// inside a stream capture (the first launch of each type comes from an
// eager dispatch or a warmup).
template <typename T, bool kWide>
cudaError_t allow_full_smem() {
  static std::once_flag once;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    err = cudaFuncSetAttribute(fused_planar_kernel<T, kWide>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemMax));
  });
  return err;
}

// One cooperative launch through cudaLaunchKernelExC with the
// cooperative attribute: the same launch eagerly and under stream
// capture, where it becomes a cooperative kernel node of the graph.
template <typename T, bool kWide>
cudaError_t launch(const Args& a, const WideMaps& maps, cudaStream_t stream) {
  const long long smem =
      kWide ? wide_fixed_bytes(a.records) +
                  static_cast<long long>(a.stages) * a.stage_bytes
            : smem_bytes(a.slice, a.group, a.stages, sizeof(T));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_full_smem<T, kWide>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {const_cast<Args*>(&a), const_cast<WideMaps*>(&maps)};
  e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(fused_planar_kernel<T, kWide>),
      params);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t launch_mode(const Args& a, const WideMaps& maps,
                        cudaStream_t stream) {
  return a.chunk > 0 ? launch<T, true>(a, maps, stream)
                     : launch<T, false>(a, maps, stream);
}

// cuTensorMapEncodeTiled, through the runtime's entry-point lookup (the
// library links no libcuda stub); null where the installed CUDA lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The (3, B, S) planes as a 3-d tensor of 8-byte elements (a row of S
// atoms is S * elem / 8 of them), boxes of `atoms` atoms x `frames`
// frames x 3 components, no swizzle, zeros past the edges.
cudaError_t planes_map(CUtensorMap* map, const void* qp, int B, int S,
                       int elem, int atoms, int frames) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(S) * elem;
  const cuuint64_t dim[3] = {row / 8, static_cast<cuuint64_t>(B), 3};
  const cuuint64_t stride[2] = {row, row * B};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(atoms * elem / 8),
                             static_cast<cuuint32_t>(frames), 3};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3,
                        const_cast<void*>(qp), dim, stride, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wide mode's fields of `a` from its geometry (chunk > 0): pass A's
// (group, chunk) and pass B's (group_b, chunk_b) units, their boxes, the
// records window and the stage.
cudaError_t wide_args(Args& a, WideMaps& maps, int elem, int group_b,
                      int chunk_b) {
  if (a.group > kComputeWarps || a.chunk % 16 != 0 ||
      a.chunk * elem > kBoxBytes || group_b < 1 ||
      group_b > kMaxGroup || chunk_b < 16 || chunk_b % 16 != 0 ||
      chunk_b > kWideChunkB) {
    return cudaErrorInvalidValue;
  }
  const int nbox = (chunk_b * elem + kBoxBytes - 1) / kBoxBytes;
  if (chunk_b % (16 * nbox) != 0) return cudaErrorInvalidValue;
  a.group_b = group_b;
  a.chunk_b = chunk_b;
  a.nbox_b = nbox;
  a.records = a.B < kWideRecords ? a.B : kWideRecords;
  a.stage_bytes = static_cast<int>(
      wide_stage_bytes(a.group, a.chunk, group_b, chunk_b, nbox, elem));
  cudaError_t e = planes_map(&maps.a, a.qp, a.B, a.S, elem, a.chunk,
                             a.group);
  if (e == cudaSuccess)
    e = planes_map(&maps.b, a.qp, a.B, a.S, elem, chunk_b / nbox, group_b);
  return e;
}

}  // namespace

// dtype: 0 = int16, 1 = int8, 2 = float32.  inv: (B,) float32 per-frame
// inverse scales, or null to use inv_scalar for every frame.  ref is the
// padded centred reference in its (S, 3) layout.  Geometry (from
// ops/fused_planar.fused_geometry): `blocks` slices of `slice` atoms (the
// last may be shorter), frames in groups of `group`, a ring of `stages`;
// `chunk` 0 for the single-read form, else the wide mode's pass-A chunk
// (a multiple of 16 atoms, at most 2048 bytes a row) and its pass-B units
// of `group_b` frames x `chunk_b` atoms (a multiple of 16 up to
// kWideChunkB, in boxes of at most 2048 bytes a row).  Scratch: part (B,
// 12, blocks) then rot (B, 16) float32, every word 0xffffffff on entry.
// Launches one cooperative kernel on `stream` and returns its error (0 on
// success).
extern "C" int mdtpu_fused_planar(const void* qp, int dtype, int B, int S,
                                  const float* inv, float inv_scalar,
                                  const float* w, const float* ref,
                                  const float* amask, const float* fmask,
                                  const float* sref, int slice, int blocks,
                                  int group, int stages, int chunk,
                                  int group_b, int chunk_b, float* scratch,
                                  float* out, void* stream) {
  if (B < 1 || S < 16 || S % 16 != 0 || slice < 16 || slice % 16 != 0 ||
      blocks < 1 || blocks > kMaxBlocks || static_cast<long long>(blocks) * slice < S ||
      static_cast<long long>(blocks - 1) * slice >= S || group < 1 ||
      group > kMaxGroup || stages < 2 || stages > kMaxStages || chunk < 0 ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  WideMaps maps = {};
  a.qp = qp;
  a.B = B;
  a.S = S;
  a.inv = inv;
  a.inv_scalar = inv_scalar;
  a.w = w;
  a.ref = ref;
  a.amask = amask;
  a.fmask = fmask;
  a.sref = sref;
  a.slice = slice;
  a.blocks = blocks;
  a.group = group;
  a.stages = stages;
  a.chunk = chunk;
  a.part = scratch;
  a.rot = scratch + static_cast<size_t>(B) * 12 * blocks;
  a.out = out;
  const int elem = dtype == 0 ? 2 : (dtype == 1 ? 1 : 4);
  cudaError_t e =
      chunk > 0 ? wide_args(a, maps, elem, group_b, chunk_b) : cudaSuccess;
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      e = launch_mode<int16_t>(a, maps, st);
      break;
    case 1:
      e = launch_mode<int8_t>(a, maps, st);
      break;
    default:
      e = launch_mode<float>(a, maps, st);
  }
  return static_cast<int>(e);
}

extern "C" const char* mdtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
