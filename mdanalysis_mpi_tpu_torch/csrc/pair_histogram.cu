// Pair-distance histogram kernel for Hopper (sm_90a): the RDF inner
// loop, a histogram of minimum-image distances between two atom groups,
// for every frame of a staged block, with no pair matrix in memory.
//
// Replaces the TPU kernel mdanalysis_mpi_tpu/ops/pallas_distances.py
// (_build_kernel, pl.pallas_call at :164) and computes the same function:
// for every frame f, atom i of group A (N atoms) and atom j of group B
// (M atoms), skipping i == j when exclude_self,
//
//   d_ax   = a[f, i, ax] - b[f, j, ax]
//   d_ax  -= rint(d_ax / L[f, ax]) * L[f, ax]     (only where L > 0)
//   d      = sqrt(0 + dx*dx + dy*dy + dz*dz)
//   counts[f, k] += 1   for the k with e_k <= d < e_{k+1}
//
// against the float32 edges e_0 < ... < e_nbins; a d outside
// [e_0, e_nbins) (or NaN) counts nowhere.  This is
// searchsorted(edges, d, 'right') - 1, the generic engine's predicate.
// The counts EQUAL those of the plain torch version
// (fused_distances.pair_histogram_plain) on every input: every float
// step below is one IEEE round-to-nearest operation written with an _rn
// intrinsic (nvcc's default --fmad=true cannot contract it into an FMA),
// and the two rewrites that make the kernel cheap are exact.
//
// 1. Minimum image without a division.  For a box length L in
//    [2^-64, FLT_MAX] let h = 0.5f * L (exact).  For |d| < L the rounded
//    quotient fl(d / L) is at most 0.5 in magnitude exactly when
//    |d| <= h (d > h means d >= h + ulp(h), so d / L exceeds 0.5 by more
//    than half an ulp of 0.5 and rounds above it), so rint gives 0 there
//    and +-1 beyond, and d - rint(d / L) * L is d for |d| <= h and
//    d - copysign(L, d) for h < |d| < L.  Only the square is used, and
//    |fl(d - copysign(L, d))| = fl(L - |d|) (rounding to nearest is
//    symmetric).  With w = |d| < L, w <= h exactly when fl(L - w) >= w
//    (fl(L - h) = h and rounding is monotone), so the wrapped |d| is
//    min(w, fl(L - w)): two subtractions and a min per axis, the
//    absolute values being operand modifiers.  On an axis without wrap
//    the kernel uses L = inf, so the min is w.  Where |d| >= L
//    (coordinates far outside the box, as in unwrapped trajectories),
//    for an infinite L and for L below 2^-64 the kernel keeps the
//    division form (__fdiv_rn, rintf).  Which form a B atom b takes is
//    decided once per CUDA block, from the least and greatest
//    coordinate lo, hi of the block's A atoms on each axis: when
//    fl(hi - b) < L and fl(b - lo) < L, every A atom a has
//    |fl(a - b)| < L (a - b <= hi - b and b - a <= b - lo, and rounding
//    is monotone and symmetric), so the min form is exact for all of
//    b's pairs.  The flag rides in the B tile's fourth float; every lane
//    of a warp reads the same B atom, so the branch on it never
//    diverges.  Coordinates wrapped into [0, L), or into any other
//    window of width L, and atoms a little outside the box take the min
//    form; only a B atom within reach of an A atom at |d| >= L takes
//    the division.  tests/test_torch_pair_histogram_algebra.py holds the
//    rewrite (fused_distances.wrap_nodiv) to the division form bit for
//    bit.
//
// 2. Range and bins on the squared distance.  Let t_k be the smallest
//    float32 t >= 0 with __fsqrt_rn(t) >= e_k (0 where e_k <= 0).  The
//    square root rounded to nearest is monotone, so sqrt(d2) >= e_k
//    exactly when d2 >= t_k, and searchsorted(edges, sqrt(d2), 'right')
//    equals searchsorted(t, d2, 'right').  Every CUDA block computes the
//    t_k into shared memory at its start, from __fmul_rn(e_k, e_k)
//    stepped by nextafterf until the predicate holds (a step or two; the
//    edges may live on the card, so the host never computes them).  A
//    pair is dropped when !(d2 < t_hi) (this also drops NaN), before any
//    square root; a pair with d2 < t_hi that also has d2 >= t_lo takes a
//    bin guess k from an approximate distance (d2 * rsqrt(d2)), keeps it
//    when t_k <= d2 < t_{k+1} and otherwise walks it against the t_k
//    until that holds, so non-uniform edges stay exact.
//    fused_distances.squared_edge_thresholds is this computation in
//    torch, tested against the square-root form.
//
// Bound on the card: by operations.  A staged block of 16 frames of
// 32,768 atoms is 6 MB for 1.7e10 pairs.  chip_smoke.py keeps the TPU
// kernel's count of the function's work as its yardstick: 23 float32
// operations for every pair (per axis sub, div, rint, mul, sub, square;
// two adds, a sqrt, two range compares) and 7 more for every pair
// inside the range.  This kernel issues fewer instructions than that
// for a pair beyond the range on the division-free form (it divides
// nowhere and takes no square root there): 18.125 SASS instructions
// per pair (R = 4, nvcc 12.8 for sm_90a; counted by
// scripts/pair_histogram_sweep.py from cuobjdump -sass, NVIDIA H100),
// one of them the per-B-atom choice of form.  None is an FMA, so at the
// main shape the loop alone takes about 9.3 ms of issue (132 SMs x 4
// warp issues a clock at 1.98 GHz) where the operations bound reads
// 5.9 ms.
//
// Design:
//   grid (ceil(N / (256 R)), ceil(M / 1024), frames): one launch per
//   staged block of frames.  Each thread holds R atoms of group A in
//   registers (atoms i0 + r * 256, r < R; R = 4, chosen by measurement
//   with scripts/pair_histogram_sweep.py), so one 16-byte broadcast
//   load of a B atom from the shared-memory tile (float4 x, y, z, pad)
//   serves R pairs.  A-slots past N hold NaN and count nowhere; the B
//   loop stops at the tile's last atom and is unrolled by 2.  The R
//   range tests of one B atom are one compare of the least of the R
//   squared distances, so a group of R pairs beyond the range pays one
//   branch.  The exclude_self test (i == j) runs only inside that
//   branch and only in CUDA blocks whose A range overlaps the B tile,
//   chosen once per block.  A binned pair adds 1 to one shared-memory
//   uint32 histogram per block (one per warp gained nothing when
//   measured); at the end the block adds its non-zero bins to the
//   frame's (frames, nbins) uint64 counts in device memory with 64-bit
//   atomics (32-bit would overflow above 65k x 65k pairs a frame).
//   Integer addition does not depend on order, so two launches give the
//   same counts bit for bit; there are no float atomics.
//
// Not done here (later work, ROADMAP B2): a cell list that skips whole B
// tiles beyond the range (it changes which pairs are visited); tensor
// cores through |a|^2 + |b|^2 - 2 a.b (it changes the rounding, so the
// counts would no longer equal the plain version's); TMA and wgmma
// (there is no matrix product here).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kR = 4;           // A atoms per thread (measured: PERF.md)
constexpr int kTileA = kThreads * kR;
constexpr int kTileB = 1024;    // B atoms staged in shared memory per block
constexpr int kMaxBins = 512;

// One axis of a frame's box: the division-free form applies where
// |d| < lim.  No wrap (L <= 0 or NaN): L = lim = inf, so w is never
// replaced.  L in [2^-64, FLT_MAX]: lim = L.  Any other L > 0 (infinite
// or tiny): lim = -1, so every d takes the division form.
struct Axis {
  float L, lim;
};

__device__ __forceinline__ Axis axis_of(float L) {
  if (!(L > 0.f)) return {INFINITY, INFINITY};
  if (L >= 0x1p-64f && L <= FLT_MAX) return {L, L};
  return {L, -1.f};
}

// True when |fl(a - b)| < lim for every a in [lo, hi], so wrap_near
// applies to b's pairs on this axis (always, on an axis without wrap).
__device__ __forceinline__ bool near_all(float b, float lo, float hi,
                                         Axis ax) {
  return ax.lim == INFINITY ||
         (__fsub_rn(hi, b) < ax.lim && __fsub_rn(b, lo) < ax.lim);
}

// Least and greatest of one axis over the warp's A slots.  fminf and
// fmaxf skip NaN, so empty slots count nowhere; a warp of NaN alone
// gives lo = inf, hi = -inf, and every one of its pairs is NaN anyway.
__device__ __forceinline__ void warp_span(const float (&v)[kR], float& lo,
                                          float& hi) {
  lo = INFINITY;
  hi = -INFINITY;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    lo = fminf(lo, v[r]);
    hi = fmaxf(hi, v[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// |minimum image of a - b| on one axis, without a division: valid where
// |a - b| < L on a regular axis, and on an axis without wrap (L = inf,
// so the min is w).  For w < L, w <= h exactly when fl(L - w) >= w
// (fl(L - h) = h and rounding is monotone), so min(w, fl(L - w)) is
// the wrapped |d|.
__device__ __forceinline__ float wrap_near(float a, float b, Axis ax) {
  const float w = fabsf(__fsub_rn(a, b));
  return fminf(w, __fsub_rn(ax.L, w));
}

// The division form, exact for every d: the plain version's wrap.
__device__ __forceinline__ float wrap_div(float a, float b, Axis ax) {
  const float d = __fsub_rn(a, b);
  if (ax.lim == INFINITY) return fabsf(d);   // no wrap on this axis
  return fabsf(__fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, ax.L)), ax.L)));
}

// d2 of the R pairs (A slots, one B atom), squares summed in the plain
// version's order.
template <bool kDiv>
__device__ __forceinline__ void pair_d2(
    float (&d2)[kR], const float (&ax)[kR], const float (&ay)[kR],
    const float (&az)[kR], float4 bj, Axis X, Axis Y, Axis Z) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float wx = kDiv ? wrap_div(ax[r], bj.x, X) : wrap_near(ax[r], bj.x, X);
    const float wy = kDiv ? wrap_div(ay[r], bj.y, Y) : wrap_near(ay[r], bj.y, Y);
    const float wz = kDiv ? wrap_div(az[r], bj.z, Z) : wrap_near(az[r], bj.z, Z);
    d2[r] = __fadd_rn(__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)),
                      __fmul_rn(wz, wz));
  }
}

// Smallest float32 t >= 0 with __fsqrt_rn(t) >= e (0 for e <= 0, NaN
// for a NaN edge, which no distance reaches).
__device__ float sqrt_threshold(float e) {
  if (e != e) return e;
  if (!(e > 0.f)) return 0.f;
  float t = __fmul_rn(e, e);
  while (__fsqrt_rn(t) < e) t = nextafterf(t, INFINITY);
  while (t > 0.f) {
    const float p = nextafterf(t, 0.f);
    if (__fsqrt_rn(p) < e) break;
    t = p;
  }
  return t;
}

// Bin of d2 in [t_0, t_nbins): a guess from an approximate distance
// (d2 * rsqrt(d2), flushing denormals; 0 * inf = NaN clamps to bin 0),
// kept when st[k] <= d2 < st[k + 1] and otherwise walked against the
// thresholds until that holds.
__device__ __forceinline__ void bin_pair(float d2, const float* st,
                                         float e_lo, float inv_dr,
                                         int nbins, unsigned int* hist) {
  float rs;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(rs) : "f"(d2));
  const float g = (d2 * rs - e_lo) * inv_dr;
  int k = static_cast<int>(fminf(fmaxf(g, 0.f), static_cast<float>(nbins - 1)));
  if (d2 < st[k] || d2 >= st[k + 1]) {   // the guess missed: walk
    while (k > 0 && d2 < st[k]) --k;
    while (k < nbins - 1 && d2 >= st[k + 1]) ++k;
  }
  atomicAdd(&hist[k], 1u);
}

template <bool kSelf>
__device__ __forceinline__ void pair_loop(
    const float (&ax)[kR], const float (&ay)[kR], const float (&az)[kR],
    int iA, const float4* sb, int nj, int j0, Axis X, Axis Y, Axis Z,
    const float* st, float t_lo, float t_hi, float e_lo, float inv_dr,
    int nbins, unsigned int* hist) {
#pragma unroll 2
  for (int jj = 0; jj < nj; ++jj) {
    const float4 bj = sb[jj];   // w: 1 when the min form covers b
    float d2[kR];
    if (bj.w != 0.f)
      pair_d2<false>(d2, ax, ay, az, bj, X, Y, Z);
    else
      pair_d2<true>(d2, ax, ay, az, bj, X, Y, Z);
    float d2_min = d2[0];   // fminf skips NaN: the least d2 that is a number
#pragma unroll
    for (int r = 1; r < kR; ++r) d2_min = fminf(d2_min, d2[r]);
    if (d2_min < t_hi) {   // some pair of the R may be in range
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (d2[r] < t_hi && d2[r] >= t_lo &&
            !(kSelf && iA + r * kThreads == j0 + jj)) {
          bin_pair(d2[r], st, e_lo, inv_dr, nbins, hist);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_hist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ lengths,
                     const float* __restrict__ edges, int N, int M, int nbins,
                     int exclude_self,
                     unsigned long long* __restrict__ counts) {
  __shared__ float4 sb[kTileB];
  __shared__ float st[kMaxBins + 1];
  __shared__ unsigned int hist[kMaxBins];
  __shared__ float span[kThreads / 32][6];   // per warp: lo x y z, hi x y z

  const int tid = threadIdx.x;
  const int frame = blockIdx.z;
  const int a0 = blockIdx.x * kTileA;
  const int iA = a0 + tid;   // A atom of register slot 0
  const int j0 = blockIdx.y * kTileB;
  const int nj = min(kTileB, M - j0);
  const Axis X = axis_of(lengths[frame * 3 + 0]);
  const Axis Y = axis_of(lengths[frame * 3 + 1]);
  const Axis Z = axis_of(lengths[frame * 3 + 2]);

  float ax[kR], ay[kR], az[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = iA + r * kThreads;
    if (i < N) {
      const float* af = a + (static_cast<size_t>(frame) * N + i) * 3;
      ax[r] = af[0];
      ay[r] = af[1];
      az[r] = af[2];
    } else {
      ax[r] = ay[r] = az[r] = NAN;   // every pair of this slot is NaN
    }
  }
  float lo[3], hi[3];   // of the block's A coordinates, per axis
  warp_span(ax, lo[0], hi[0]);
  warp_span(ay, lo[1], hi[1]);
  warp_span(az, lo[2], hi[2]);
  if (tid % 32 == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      span[tid / 32][c] = lo[c];
      span[tid / 32][3 + c] = hi[c];
    }
  }
  const float* bf = b + (static_cast<size_t>(frame) * M + j0) * 3;
  for (int k = tid; k < nj; k += kThreads)
    sb[k] = make_float4(bf[3 * k], bf[3 * k + 1], bf[3 * k + 2], 0.f);
  for (int k = tid; k <= nbins; k += kThreads) st[k] = sqrt_threshold(edges[k]);
  for (int k = tid; k < nbins; k += kThreads) hist[k] = 0u;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], span[w][c]);
      hi[c] = fmaxf(hi[c], span[w][3 + c]);
    }
  }
  for (int k = tid; k < nj; k += kThreads) {   // the B atoms this thread staged
    const float4 v = sb[k];
    const bool near = near_all(v.x, lo[0], hi[0], X) &&
                      near_all(v.y, lo[1], hi[1], Y) &&
                      near_all(v.z, lo[2], hi[2], Z);
    sb[k].w = near ? 1.f : 0.f;
  }
  __syncthreads();

  const float t_lo = st[0];
  const float t_hi = st[nbins];
  const float e_lo = edges[0];
  // the bin guess only; the walk against st makes the bin exact
  const float inv_dr = static_cast<float>(nbins) / (edges[nbins] - e_lo);
  const bool self = exclude_self && a0 < j0 + nj && j0 < min(N, a0 + kTileA);
  if (self)
    pair_loop<true>(ax, ay, az, iA, sb, nj, j0, X, Y, Z, st, t_lo, t_hi,
                    e_lo, inv_dr, nbins, hist);
  else
    pair_loop<false>(ax, ay, az, iA, sb, nj, j0, X, Y, Z, st, t_lo, t_hi,
                     e_lo, inv_dr, nbins, hist);
  __syncthreads();

  unsigned long long* cf = counts + static_cast<size_t>(frame) * nbins;
  for (int k = tid; k < nbins; k += kThreads) {
    const unsigned int c = hist[k];
    if (c) atomicAdd(&cf[k], static_cast<unsigned long long>(c));
  }
}

}  // namespace

// a: (B, N, 3) and b: (B, M, 3) float32 coordinates; lengths: (B, 3)
// float32 box lengths (0 = no wrap on that axis); edges: (nbins + 1,)
// increasing float32.  counts: (B, nbins) uint64, zeroed by the caller;
// the kernel adds to it.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mdtpu_pair_histogram(const float* a, const float* b,
                                    const float* lengths, const float* edges,
                                    int B, int N, int M, int nbins,
                                    int exclude_self,
                                    unsigned long long* counts,
                                    void* stream) {
  const int tiles_b = (M + kTileB - 1) / kTileB;
  if (B < 1 || N < 1 || M < 1 || nbins < 1 || nbins > kMaxBins ||
      B > 65535 || tiles_b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kTileA - 1) / kTileA, tiles_b, B);
  pair_hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, lengths, edges, N, M, nbins, exclude_self, counts);
  return static_cast<int>(cudaGetLastError());
}
