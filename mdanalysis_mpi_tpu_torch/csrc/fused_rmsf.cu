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
// above 587,008 / 663,040 / 477,184 atoms on 132 SMs), the wrapper passes
// a chunk (at most 768 atoms, a multiple of 16) and the same launch reads
// the block twice, a chunk of the slice at a time through the same ring,
// with no per-atom area in shared memory.  The solver and the rotations
// warp are unchanged; the 12 compute warps take both roles in turn:
//   - pass A, units (group g, chunk c) in the order g, then c: warp w
//     takes frames w and w + 12 of the group, w and ref from global
//     memory (L1, 16-byte loads), and carries their 12 sums in
//     registers over the slice's chunks; after the last it publishes
//     them as above.
//   - pass B, units (chunk c, group g) in the order c, then g: thread t
//     takes atoms 2t and 2t + 1 of the chunk and carries their moments in
//     registers over the groups, whose records the rotations warp loads
//     once a chunk; after the last group it writes the chunk's (6, chunk)
//     output, amask applied.
// Every sum keeps a fixed order (per atom: frames 0..B-1; per frame: the
// chunks in order, then the blocks), so the wide output is bit-identical
// from run to run too.  The function's bound stays one read of the
// block; the wide mode reads it twice.  ops/fused_planar.fused_geometry
// sizes the chunk so that four stages fit (int16 group 12 and int8 group
// 24: 72 B an atom a stage; float32 group 12: 144 B): S = 1,048,576 on
// 132 SMs gives slices of 7,952 atoms in chunks of 736 (float32 384).
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
// ~84 frames.  The wide mode at B = 512, S = 1,048,576 (phase 3's wide
// rows, same card): int16 3.580 ms, int8 2.497, float32 5.145, against
// one read's bound of 0.975 / 0.505 (operations) / 1.937 ms.

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
// wide mode: two atoms a compute thread a chunk
constexpr int kWideChunk = 2 * kComputeThreads;
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
  int chunk;          // wide mode: atoms a chunk (0: the single-read form)
  float* part;        // (B, 12, blocks), kUnset on entry
  float* rot;         // (B, kRot), kUnset on entry
  float* out;         // (6, S)
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

// The wide mode's layout: the same header, then the ring of stages, each
// (3, G, chunk) of T.
__host__ __device__ inline long long wide_smem_bytes(int chunk, int group,
                                                     int stages, int elem) {
  return fixed_bytes(group) +
         static_cast<long long>(stages) * 3 * group * chunk * elem;
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

// Unit u of a block whose slice has nck chunks, for ng groups: pass A's
// units (g, c) in the order g, then c; then pass B's in the order c, g.
__device__ __forceinline__ void wide_unit(int u, int ng, int nck, int& g,
                                          int& c) {
  const int na = ng * nck;
  if (u < na) {
    g = u / nck;
    c = u - g * nck;
  } else {
    c = (u - na) / ng;
    g = (u - na) - c * ng;
  }
}

// The loader warp: unit u's rows (3*gf rows of the chunk's atoms) into
// its stage, one bulk copy per row.
template <typename T>
__device__ __forceinline__ void wide_copy(const Args& a, T* ring,
                                          uint64_t* full, int u, int ng,
                                          int nck, int s0, int ns,
                                          int lane) {
  int g, c;
  wide_unit(u, ng, nck, g, c);
  const int G = a.group;
  const int stage = u % a.stages;
  const int f0 = g * G;
  const int gf = min(G, a.B - f0);
  const int c0 = c * a.chunk;
  const uint32_t bytes =
      static_cast<uint32_t>(min(a.chunk, ns - c0)) * sizeof(T);
  T* base = ring + static_cast<size_t>(stage) * 3 * G * a.chunk;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) mbar_expect_tx(&full[stage], 3u * gf * bytes);
  __syncwarp();
  const T* qp = static_cast<const T*>(a.qp);
  for (int k = lane; k < 3 * gf; k += 32) {
    const int comp = k / gf;
    const int f = k - comp * gf;
    const T* src =
        qp + (static_cast<size_t>(comp) * a.B + f0 + f) * a.S + s0 + c0;
    bulk_copy(base + (static_cast<size_t>(comp) * G + f) * a.chunk, src,
              bytes, &full[stage]);
  }
}

template <typename T>
__device__ void wide_loader(const Args& a, T* ring, uint64_t* full,
                            uint64_t* empty, int ng, int nck, int s0, int ns,
                            int lane) {
  const int nu = 2 * ng * nck;
  const int nst = a.stages;
  for (int u = 0; u < min(nst, nu); ++u)
    wide_copy(a, ring, full, u, ng, nck, s0, ns, lane);
  for (int u = nst; u < nu; ++u) {
    mbar_wait(&empty[u % nst], ((u - nst) / nst) & 1);
    wide_copy(a, ring, full, u, ng, nck, s0, ns, lane);
  }
}

// The rotations warp: for each of pass B's units (chunk c, group g), the
// group's records into the next of the four buffers.
__device__ void wide_rotations(const Args& a, float* frot, uint64_t* rfull,
                               uint64_t* rempty, int ng, int nck, int lane) {
  const int G = a.group;
  for (int v = 0; v < nck * ng; ++v) {
    const int g = v % ng;
    const int rb = v % kRotBuffers;
    if (v >= kRotBuffers)
      mbar_wait(&rempty[rb], ((v - kRotBuffers) / kRotBuffers) & 1);
    load_records(a.rot + static_cast<size_t>(g) * G * kRot,
                 frot + rb * G * kRot, min(G, a.B - g * G), lane);
    warp_arrive(&rfull[rb], lane);
  }
}

// The 12 compute warps (w = warp - 1): pass A, then pass B.
template <typename T>
__device__ void wide_compute(const Args& a, const T* ring, const float* frot,
                             uint64_t* full, uint64_t* empty, uint64_t* rfull,
                             uint64_t* rempty, volatile int* sprog, int ng,
                             int nck, int s0, int ns, int warp, int lane) {
  const int G = a.group;
  const int ck = a.chunk;
  const int nst = a.stages;
  const int nblk = a.blocks;
  const int w = warp - kFirstSumWarp;
  const size_t plane = static_cast<size_t>(G) * ck;
  const int na = ng * nck;

  // ---- pass A: frames fa and fb of each group, their sums carried over
  // the chunks and published after the last
  const int fa = w, fb = w + kComputeWarps;
  float sa[12], sb[12];
  for (int u = 0; u < na; ++u) {
    const int g = u / nck;
    const int c = u - g * nck;
    const int stage = u % nst;
    mbar_wait(&full[stage], (u / nst) & 1);
    const int gf = min(G, a.B - g * G);
    if (c == 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        sa[k] = 0.0f;
        sb[k] = 0.0f;
      }
    }
    const int c0 = c * ck;
    const int nch = min(ck, ns - c0) / 4;
    const T* base = ring + static_cast<size_t>(stage) * 3 * plane;
    if (fa < gf) {
      const bool two = fb < gf;
      const T* xa = base + static_cast<size_t>(fa) * ck;
      const T* xb = base + static_cast<size_t>(two ? fb : fa) * ck;
      for (int j = lane; j < nch; j += 32) {
        // w and ref of atoms s..s+3 in four 16-byte loads (s % 4 == 0;
        // the wrapper requires w and ref 16-byte aligned): ref's 12
        // interleaved floats de-interleaved in registers
        const size_t s = static_cast<size_t>(s0) + c0 + 4 * j;
        const float4 wv = __ldg(reinterpret_cast<const float4*>(a.w + s));
        const float4* rp = reinterpret_cast<const float4*>(a.ref + 3 * s);
        const float4 r0 = __ldg(rp), r1 = __ldg(rp + 1), r2 = __ldg(rp + 2);
        const float p[16] = {wv.x, wv.y, wv.z, wv.w,
                             r0.x, r0.w, r1.z, r2.y,
                             r0.y, r1.x, r1.w, r2.z,
                             r0.z, r1.y, r2.x, r2.w};
        chunk_sums(xa, xa + plane, xa + 2 * plane, j, p, sa);
        if (two) chunk_sums(xb, xb + plane, xb + 2 * plane, j, p, sb);
      }
    }
    warp_arrive(&empty[stage], lane);
    if (c == nck - 1) {
      const int k = (lane >> 1) & 15;
      const bool writer = (lane & 1) == 0 && k < 12;
      if (fa < gf) {
        const float va = reduce12(sa, lane);
        if (writer)
          st_relaxed(a.part + ((static_cast<size_t>(g) * G + fa) * 12 + k) *
                                  nblk + blockIdx.x,
                     va);
      }
      if (fb < gf) {
        const float vb = reduce12(sb, lane);
        if (writer)
          st_relaxed(a.part + ((static_cast<size_t>(g) * G + fb) * 12 + k) *
                                  nblk + blockIdx.x,
                     vb);
      }
      // the frame solver's hint reads the first kSumWarps warps
      if (lane == 0 && w < kSumWarps) sprog[w] = g + 1;
    }
  }

  // ---- pass B: atoms i and i + 1 of each chunk, their moments carried
  // over the groups and written after the last
  const int i = 2 * (threadIdx.x - kFirstSumWarp * 32);
  float sd[2][3], sq[2][3], r[2][3];
  for (int v = 0; v < nck * ng; ++v) {
    const int c = v / ng;
    const int g = v - c * ng;
    const int u = na + v;
    const int stage = u % nst;
    const int rb = v % kRotBuffers;
    const int c0 = c * ck;
    const bool mine = i < min(ck, ns - c0);
    const size_t s = static_cast<size_t>(s0) + c0 + i;
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          sd[e][q] = 0.0f;
          sq[e][q] = 0.0f;
          r[e][q] = mine ? __ldg(a.ref + 3 * (s + e) + q) : 0.0f;
        }
      }
    }
    mbar_wait(&full[stage], (u / nst) & 1);
    mbar_wait(&rfull[rb], (v / kRotBuffers) & 1);
    if (mine)
      add_frames(reinterpret_cast<const float4*>(frot + rb * G * kRot),
                 ring + static_cast<size_t>(stage) * 3 * plane + i,
                 min(G, a.B - g * G), G, ck, r, sd, sq);
    warp_arrive(&empty[stage], lane);
    warp_arrive(&rempty[rb], lane);
    if (g == ng - 1 && mine) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float am = __ldg(a.amask + s + e);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          a.out[q * static_cast<size_t>(a.S) + s + e] = sd[e][q] * am;
          a.out[(3 + q) * static_cast<size_t>(a.S) + s + e] =
              sq[e][q] * (am * am);
        }
      }
    }
  }
}

// The kernel; its warps' roles are described at the top of the file.
// kWide selects the wide mode (a.chunk > 0).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
fused_planar_kernel(const Args a) {
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
  // the wide mode has no per-atom area: its ring follows the header
  T* ring = kWide ? reinterpret_cast<T*>(pw)
                  : reinterpret_cast<T*>(acc + 6 * slice);

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
    // the wide mode's roles; its frame solver is the one below
    const int nck = (ns + a.chunk - 1) / a.chunk;   // chunks of the slice
    if (warp == kLoaderWarp) {
      wide_loader(a, ring, full, empty, ng, nck, s0, ns, lane);
      return;
    }
    if (warp == kRotWarp) {
      wide_rotations(a, frot, rfull, rempty, ng, nck, lane);
      return;
    }
    if (warp != kSolverWarp) {
      wide_compute(a, ring, frot, full, empty, rfull, rempty, sprog, ng,
                   nck, s0, ns, warp, lane);
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
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long smem =
      kWide ? wide_smem_bytes(a.chunk, a.group, a.stages, sizeof(T))
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
  void* params[] = {const_cast<Args*>(&a)};
  e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(fused_planar_kernel<T, kWide>),
      params);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t launch_mode(const Args& a, cudaStream_t stream) {
  return a.chunk > 0 ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// dtype: 0 = int16, 1 = int8, 2 = float32.  inv: (B,) float32 per-frame
// inverse scales, or null to use inv_scalar for every frame.  ref is the
// padded centred reference in its (S, 3) layout.  Geometry (from
// ops/fused_planar.fused_geometry): `blocks` slices of `slice` atoms (the
// last may be shorter), frames in groups of `group`, a ring of `stages`;
// `chunk` 0 for the single-read form, else the wide mode's chunk (a
// multiple of 16 up to kWideChunk atoms).  Scratch: part (B, 12, blocks)
// then rot (B, 16) float32, every word 0xffffffff on entry.  Launches one
// cooperative kernel on `stream` and returns its error (0 on success).
extern "C" int mdtpu_fused_planar(const void* qp, int dtype, int B, int S,
                                  const float* inv, float inv_scalar,
                                  const float* w, const float* ref,
                                  const float* amask, const float* fmask,
                                  const float* sref, int slice, int blocks,
                                  int group, int stages, int chunk,
                                  float* scratch, float* out, void* stream) {
  if (B < 1 || S < 16 || S % 16 != 0 || slice < 16 || slice % 16 != 0 ||
      blocks < 1 || blocks > kMaxBlocks || static_cast<long long>(blocks) * slice < S ||
      static_cast<long long>(blocks - 1) * slice >= S || group < 1 ||
      group > kMaxGroup || stages < 2 || stages > kMaxStages ||
      chunk < 0 || chunk % 16 != 0 || chunk > kWideChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_mode<int16_t>(a, st);
      break;
    case 1:
      e = launch_mode<int8_t>(a, st);
      break;
    case 2:
      e = launch_mode<float>(a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* mdtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
