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
//
// Rounding.  Every step is written with the _rn intrinsics so that nvcc's
// default --fmad=true cannot contract a multiply into an add: the
// distances equal, bit for bit, those of the plain torch version
// (fused_distances.pair_histogram_plain), whose elementwise ops never
// fuse, and the counts equal its counts exactly.  The wrap divides by L
// (never multiplies by 1/L, which re-creates bin-edge ties) and rounds
// half to even (rintf, as torch.round and jnp.round do).
//
// Bound on the card: by operations.  A CUDA block reads 15 KB of
// coordinates for 262,144 pairs (a staged block of 16 frames of 32,768
// atoms is 6 MB for 1.7e10 pairs).  Every pair costs 23 float32
// operations (per axis sub, div, rint, mul, sub, square; two adds, a
// sqrt, two range compares) and every pair inside the range 7 more (sub,
// mul, floor, two clamps, two edge compares); chip_smoke.py bounds the
// kernel with these counts.  IEEE division and sqrt take several
// instructions each, so that bound is optimistic.
//
// Design (a simple, correct first form):
//   grid (ceil(N / 256), ceil(M / 1024), frames): one launch per block of
//   frames.  Each CUDA block holds 256 A atoms in registers (one per
//   thread) and stages 1,024 B atoms (SoA, 12 KB) and the edges in
//   shared memory; every thread walks the B tile (broadcast reads).
//   A pair inside the range takes the bin guess floor((d - e_0) * nbins /
//   (e_nbins - e_0)), moved by +-1 until e_k <= d < e_{k+1} against the
//   edges in shared memory (so non-uniform edges are still exact, only
//   slower), and adds 1 to a shared-memory uint32 histogram.  At the end
//   the block adds its non-zero bins to the frame's (frames, nbins) uint64
//   counts in device memory with 64-bit atomics (32-bit would overflow
//   above 65k x 65k pairs a frame).  Integer addition does not depend on
//   order, so two launches give the same counts bit for bit; there are no
//   float atomics.  Shared-memory atomics on the few hot bins near the
//   first peak of g(r) serialise; per-warp histograms are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // A atoms per block, one per thread
constexpr int kTileB = 1024;    // B atoms staged in shared memory per block
constexpr int kMaxBins = 512;

__device__ __forceinline__ float wrap(float d, float L) {
  // d - rint(d / L) * L, each step rounded on its own (no contraction)
  return __fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, L)), L));
}

__global__ void __launch_bounds__(kThreads)
    pair_hist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ lengths,
                     const float* __restrict__ edges, int N, int M, int nbins,
                     int exclude_self,
                     unsigned long long* __restrict__ counts) {
  __shared__ float sb[3][kTileB];
  __shared__ float se[kMaxBins + 1];
  __shared__ unsigned int hist[kMaxBins];

  const int tid = threadIdx.x;
  const int frame = blockIdx.z;
  const int i = blockIdx.x * kThreads + tid;
  const int j0 = blockIdx.y * kTileB;
  const int nj = min(kTileB, M - j0);

  // stage the B tile: 3 * nj contiguous floats, coalesced, into SoA
  const float* bf = b + (static_cast<size_t>(frame) * M + j0) * 3;
  for (int k = tid; k < nj * 3; k += kThreads) sb[k % 3][k / 3] = bf[k];
  for (int k = tid; k <= nbins; k += kThreads) se[k] = edges[k];
  for (int k = tid; k < nbins; k += kThreads) hist[k] = 0u;

  const float Lx = lengths[frame * 3 + 0];
  const float Ly = lengths[frame * 3 + 1];
  const float Lz = lengths[frame * 3 + 2];
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (i < N) {
    const float* af = a + (static_cast<size_t>(frame) * N + i) * 3;
    ax = af[0];
    ay = af[1];
    az = af[2];
  }
  __syncthreads();

  if (i < N) {
    const float e_lo = se[0];
    const float e_hi = se[nbins];
    // the bin guess only; the walk below makes the bin exact
    const float inv_dr = static_cast<float>(nbins) / (e_hi - e_lo);
    const float kmax = static_cast<float>(nbins - 1);
    for (int jj = 0; jj < nj; ++jj) {
      if (exclude_self && i == j0 + jj) continue;
      float dx = __fsub_rn(ax, sb[0][jj]);
      float dy = __fsub_rn(ay, sb[1][jj]);
      float dz = __fsub_rn(az, sb[2][jj]);
      if (Lx > 0.f) dx = wrap(dx, Lx);
      if (Ly > 0.f) dy = wrap(dy, Ly);
      if (Lz > 0.f) dz = wrap(dz, Lz);
      float d2 = __fmul_rn(dx, dx);
      d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      const float d = __fsqrt_rn(d2);
      if (!(d >= e_lo && d < e_hi)) continue;   // also drops NaN
      const float g = floorf(__fmul_rn(__fsub_rn(d, e_lo), inv_dr));
      int k = static_cast<int>(fminf(fmaxf(g, 0.f), kmax));
      while (k > 0 && d < se[k]) --k;
      while (k < nbins - 1 && d >= se[k + 1]) ++k;
      atomicAdd(&hist[k], 1u);
    }
  }
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
  const dim3 grid((N + kThreads - 1) / kThreads, tiles_b, B);
  pair_hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, lengths, edges, N, M, nbins, exclude_self, counts);
  return static_cast<int>(cudaGetLastError());
}
