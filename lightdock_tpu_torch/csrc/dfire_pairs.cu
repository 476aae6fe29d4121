// DFIRE pair kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K1 replaces lightdock_tpu/ops/pallas_energy.py:_dfire_kernel_v2 and K2
// its work-list form _dfire_kernel_v2_wl; both run the TPU body
// _dfire_v2_tile_body, and here both run tile_body below.  For every pose:
// the raw DFIRE sum over receptor x ligand atom pairs with d2 <= 225, each
// pair taking the cumulative potential at the bin of d2, plus per-atom
// interface flags at d2 <= 2.45^2.  (receptor tile, ligand tile, pose
// chunk) triples whose cull bit is 0 are skipped.  The receptor is rigid
// (one copy for all poses) or per pose (receptor ANM).
//
// K1 runs one block per (tile, chunk) over the whole tile grid.  K2 first
// compacts the tiles with any active chunk into a list, in tile order
// (compact_tiles_kernel: one block, the count stays on the device), then
// runs one block per (list slot, chunk) on a grid sized to every tile;
// slots past the count return at once.  Partial sums go to per-slot rows
// and the second pass adds only the listed rows, in list order.
//
// What bounds them on this card: not bytes (the coordinates of a 16-pose
// chunk are a few KB) but the per-pair issue rate (d2, the bin search, the
// mask) and the table gather, which hits L1/L2.  What the design does:
//   * 256 threads a block; each thread owns one ligand atom and keeps its
//     coordinates for all 16 poses in registers, so the inner loop over
//     poses reads no shared or global memory for the ligand;
//   * the receptor tile sits in shared memory: 32 rows, or 16 poses x 32
//     rows (6 KB) for a per-pose receptor; a warp reads one row at a time,
//     a broadcast, and the rigid case stages one copy;
//   * the table is laid out pair-major, cum[i][type_j][bin], so all bins of
//     one atom pair share a 128-byte line and the 16 poses of a chunk hit
//     the same line one after another;
//   * the bin is a 5-step binary search over the live thresholds held in
//     shared memory (padded with +inf), not a 20-compare chain; chunks
//     whose near bit is 0 start the search at the far split, as the TPU
//     kernel's far subtree did;
//   * sums are deterministic: no float atomics.  Each block reduces its
//     per-pose sums in a fixed tree and writes them to its partial row; a
//     second kernel adds the rows in order;
//   * interface hits are kept as 16-bit pose masks in registers, one per
//     receptor row and one for the thread's ligand atom, and stored after
//     the pose loop, only for the poses hit.  Storing inside the pose loop
//     instead kept 16 pairs of flag addresses live in registers, which cut
//     the blocks an SM could hold and slowed both kernels.
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
//
// d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with explicit round-to-nearest
// intrinsics: no contraction into FMA, so d2 is bit-equal to the plain
// PyTorch version and no pair moves across a bin edge between the two.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <limits>

#include "sum_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 16;       // poses per chunk (POSE_BLOCK)
constexpr int kMaxChannels = 32;
constexpr int kMaxRTile = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCompactThreads = 1024;
constexpr int kMaxGridY = 65535;

struct Thresholds {
  float v[kMaxChannels];
};

struct Inputs {
  const float* rec;         // (1 | gp, nr_pad, 3)
  const float* lig;         // (gp, 3, nl_pad)
  const float* cum;         // (nr_pad, t1, kp)
  const int32_t* lig_type;  // (nl_pad,)
  const int32_t* act;       // (n_r, n_l, n_chunks)
  const int32_t* iface_act; // (n_r, n_l, gp)
  const int32_t* near;      // (n_r, n_l, n_chunks) or null
  float* ifr;               // (gp, nr_pad) or null
  float* ifl;               // (gp, nl_pad) or null
  int nr_pad, nl_pad, gp, r_tile, l_tile, t1, kp, n_k, split, n_l, n_chunks;
  float cutoff2, iface2;
};

// One (receptor tile r, ligand tile l, pose chunk c); writes the chunk's
// 16 per-pose sums to part[0..15].
template <bool kPerPose>
__device__ __forceinline__ void tile_body(const Inputs& in, const Thresholds& thr,
                                          int r, int l, int c, float* part) {
  __shared__ float s_rec[(kPerPose ? kPoses : 1) * kMaxRTile * 3];
  __shared__ float s_thr[2 * kMaxChannels];
  __shared__ float s_red[kWarps][kPoses];

  const int tile = r * in.n_l + l;
  const int c0 = c * kPoses;
  const int tid = threadIdx.x;

  if (in.act[(size_t)tile * in.n_chunks + c] == 0) {
    if (tid < kPoses) part[tid] = 0.0f;
    return;
  }
  const bool is_near =
      in.near == nullptr || in.near[(size_t)tile * in.n_chunks + c] != 0;
  bool do_iface = false;
  if (in.ifr != nullptr && is_near) {
    const int32_t* ia = in.iface_act + (size_t)tile * in.gp + c0;
    for (int p = 0; p < kPoses; ++p) do_iface |= ia[p] != 0;
  }
  // Far chunk: no pair is nearer than thresholds[split], so the search
  // starts there, and no pair can be inside the interface cutoff.
  const int k_lo = is_near ? 0 : in.split;

  const int r_tile = in.r_tile;
  const int r0 = r * r_tile;
  const int l0 = l * in.l_tile;
  if (kPerPose) {
    // s_rec[(p * r_tile + i) * 3 + x] = rec[c0 + p][r0 + i][x]
    for (int x = tid; x < kPoses * r_tile * 3; x += kThreads) {
      const int p = x / (r_tile * 3);
      const int rest = x - p * r_tile * 3;
      s_rec[x] = in.rec[((size_t)(c0 + p) * in.nr_pad + r0) * 3 + rest];
    }
  } else {
    for (int x = tid; x < r_tile * 3; x += kThreads) s_rec[x] = in.rec[(size_t)r0 * 3 + x];
  }
  if (tid < 2 * kMaxChannels) s_thr[tid] = tid < in.n_k ? thr.v[tid] : CUDART_INF_F;
  __syncthreads();

  // Thread -> (ligand atom j, receptor rows i0, i0 + row_step, ...).
  const int j = tid % in.l_tile;
  const int i0 = tid / in.l_tile;
  const int row_step = kThreads / in.l_tile;

  float lx[kPoses], ly[kPoses], lz[kPoses], acc[kPoses];
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    const float* lp = in.lig + (size_t)(c0 + p) * 3 * in.nl_pad + l0 + j;
    lx[p] = lp[0];
    ly[p] = lp[in.nl_pad];
    lz[p] = lp[2 * in.nl_pad];
    acc[p] = 0.0f;
  }
  const int tb = in.lig_type[l0 + j];

  unsigned lig_hits = 0;  // bit p: ligand atom j touches the interface in pose c0 + p
  for (int i = i0; i < r_tile; i += row_step) {
    const float* row = in.cum + ((size_t)(r0 + i) * in.t1 + tb) * in.kp;
    unsigned rec_hits = 0;  // bit p: receptor atom r0 + i does, in pose c0 + p
#pragma unroll
    for (int p = 0; p < kPoses; ++p) {
      const float* rp = s_rec + ((kPerPose ? p * r_tile : 0) + i) * 3;
      const float dx = __fsub_rn(lx[p], rp[0]);
      const float dy = __fsub_rn(ly[p], rp[1]);
      const float dz = __fsub_rn(lz[p], rp[2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= in.cutoff2) {
        // Largest b >= k_lo with thresholds[b] <= d2 (thresholds ascend).
        int b = k_lo;
#pragma unroll
        for (int step = kMaxChannels / 2; step > 0; step >>= 1) {
          if (d2 >= s_thr[b + step]) b += step;
        }
        acc[p] = __fadd_rn(acc[p], __ldg(row + b));
      }
      rec_hits |= (d2 <= in.iface2 ? 1u : 0u) << p;
    }
    if (do_iface && rec_hits != 0) {
      lig_hits |= rec_hits;
      for (unsigned m = rec_hits; m != 0; m &= m - 1) {
        in.ifr[(size_t)(c0 + __ffs(m) - 1) * in.nr_pad + r0 + i] = 1.0f;
      }
    }
  }
  for (unsigned m = lig_hits; m != 0; m &= m - 1) {
    in.ifl[(size_t)(c0 + __ffs(m) - 1) * in.nl_pad + l0 + j] = 1.0f;
  }

  // Fixed-order block reduction of the 16 per-pose sums.
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][p] = v;
  }
  __syncthreads();
  if (tid < kPoses) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
    part[tid] = s;
  }
}

// K1: grid (n_chunks, n_l, n_r); partial row = tile.
template <bool kPerPose>
__global__ void __launch_bounds__(kThreads)
dfire_pairs_kernel(Inputs in, Thresholds thr, float* __restrict__ partial) {
  const int c = blockIdx.x, l = blockIdx.y, r = blockIdx.z;
  tile_body<kPerPose>(in, thr, r, l, c,
                      partial + (size_t)(r * in.n_l + l) * in.gp + c * kPoses);
}

// K2: grid (n_chunks, n_tiles); partial row = list slot.
template <bool kPerPose>
__global__ void __launch_bounds__(kThreads)
dfire_pairs_worklist_kernel(Inputs in, Thresholds thr,
                            const int32_t* __restrict__ worklist,
                            const int32_t* __restrict__ n_active,
                            float* __restrict__ partial) {
  const int c = blockIdx.x, slot = blockIdx.y;
  if (slot >= *n_active) return;
  const int tile = worklist[slot];
  tile_body<kPerPose>(in, thr, tile / in.n_l, tile % in.n_l, c,
                      partial + (size_t)slot * in.gp + c * kPoses);
}

// worklist[0..n) = the tiles with any active chunk, ascending; *n_active = n.
// One block: a ballot and a warp scan per 1024 tiles, in tile order.
__global__ void __launch_bounds__(kCompactThreads)
compact_tiles_kernel(const int32_t* __restrict__ act, int n_tiles, int n_chunks,
                     int32_t* __restrict__ worklist, int32_t* __restrict__ n_active) {
  __shared__ int s_count[kCompactThreads / 32];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += kCompactThreads) {
    const int t = t0 + threadIdx.x;
    bool live = false;
    if (t < n_tiles) {
      for (int c = 0; c < n_chunks; ++c) live |= act[(size_t)t * n_chunks + c] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the per-warp counts
      int v = s_count[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
      }
      s_count[lane] = v;
    }
    __syncthreads();
    if (live) {
      const int before = (warp > 0 ? s_count[warp - 1] : 0) +
                         __popc(ballot & ((1u << lane) - 1u));
      worklist[s_base + before] = t;
    }
    __syncthreads();
    if (threadIdx.x == 0) s_base += s_count[kCompactThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_active = s_base;
}

// Checks the shapes and fills in and thr; 0 or a CUDA error code.
int prepare(const void* rec, const void* lig, const void* cum,
            const void* lig_type, const void* act, const void* iface_act,
            const void* near, void* ifr, void* ifl, int nr_pad, int nl_pad,
            int gp, int rec_poses, int r_tile, int l_tile, int t1, int kp,
            const float* thresholds, int n_k, int split, float cutoff2,
            float iface2, Inputs* in, Thresholds* thr) {
  if (r_tile <= 0 || r_tile > kMaxRTile || l_tile <= 0 ||
      l_tile > kThreads || kThreads % l_tile != 0 || n_k < 1 ||
      n_k > kMaxChannels || split < 0 || split >= n_k || nr_pad % r_tile != 0 ||
      nl_pad % l_tile != 0 || gp % kPoses != 0 || kp < n_k ||
      (rec_poses != 1 && rec_poses != gp)) {
    return (int)cudaErrorInvalidValue;
  }
  const float inf = std::numeric_limits<float>::infinity();
  for (int k = 0; k < kMaxChannels; ++k) thr->v[k] = k < n_k ? thresholds[k] : inf;
  *in = Inputs{static_cast<const float*>(rec), static_cast<const float*>(lig),
               static_cast<const float*>(cum), static_cast<const int32_t*>(lig_type),
               static_cast<const int32_t*>(act), static_cast<const int32_t*>(iface_act),
               static_cast<const int32_t*>(near), static_cast<float*>(ifr),
               static_cast<float*>(ifl), nr_pad, nl_pad, gp, r_tile, l_tile, t1, kp,
               n_k, split, nl_pad / l_tile, gp / kPoses, cutoff2, iface2};
  return 0;
}

}  // namespace

extern "C" int dfire_pairs_launch(
    const void* rec, const void* lig, const void* cum, const void* lig_type,
    const void* act, const void* iface_act, const void* near, void* partial,
    void* raw, void* ifr, void* ifl, int nr_pad, int nl_pad, int gp,
    int rec_poses, int r_tile, int l_tile, int t1, int kp,
    const float* thresholds, int n_k, int split, float cutoff2, float iface2,
    void* stream) {
  Inputs in;
  Thresholds thr;
  int err = prepare(rec, lig, cum, lig_type, act, iface_act, near, ifr, ifl,
                    nr_pad, nl_pad, gp, rec_poses, r_tile, l_tile, t1, kp,
                    thresholds, n_k, split, cutoff2, iface2, &in, &thr);
  if (err != 0) return err;
  const int n_r = nr_pad / r_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(in.n_chunks, in.n_l, n_r);
  float* f_part = static_cast<float*>(partial);
  if (rec_poses == 1) {
    dfire_pairs_kernel<false><<<grid, kThreads, 0, s>>>(in, thr, f_part);
  } else {
    dfire_pairs_kernel<true><<<grid, kThreads, 0, s>>>(in, thr, f_part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), n_r * in.n_l, gp, s);
}

extern "C" int dfire_pairs_worklist_launch(
    const void* rec, const void* lig, const void* cum, const void* lig_type,
    const void* act, const void* iface_act, const void* near, void* worklist,
    void* n_active, void* partial, void* raw, void* ifr, void* ifl, int nr_pad,
    int nl_pad, int gp, int rec_poses, int r_tile, int l_tile, int t1, int kp,
    const float* thresholds, int n_k, int split, float cutoff2, float iface2,
    void* stream) {
  Inputs in;
  Thresholds thr;
  int err = prepare(rec, lig, cum, lig_type, act, iface_act, near, ifr, ifl,
                    nr_pad, nl_pad, gp, rec_poses, r_tile, l_tile, t1, kp,
                    thresholds, n_k, split, cutoff2, iface2, &in, &thr);
  if (err != 0) return err;
  const int n_tiles = (nr_pad / r_tile) * in.n_l;
  if (n_tiles > kMaxGridY) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* wl = static_cast<int32_t*>(worklist);
  int32_t* n_act = static_cast<int32_t*>(n_active);
  float* f_part = static_cast<float*>(partial);
  compact_tiles_kernel<<<1, kCompactThreads, 0, s>>>(in.act, n_tiles, in.n_chunks,
                                                     wl, n_act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(in.n_chunks, n_tiles);
  if (rec_poses == 1) {
    dfire_pairs_worklist_kernel<false><<<grid, kThreads, 0, s>>>(in, thr, wl, n_act, f_part);
  } else {
    dfire_pairs_worklist_kernel<true><<<grid, kThreads, 0, s>>>(in, thr, wl, n_act, f_part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, n_act, static_cast<float*>(raw), 0, gp, s);
}
