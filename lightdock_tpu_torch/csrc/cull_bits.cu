// The box cull for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no TPU kernel: on the TPU the cull was XLA-side work ahead of
// the Pallas kernels (lightdock_tpu/ops/pallas_energy.py cull_mask_boxes,
// the sub-box and chunk ORs of engine/energy_pallas.py).  The port ran the
// same chain as broadcast PyTorch operations (ops/cull.py
// cull_tile_bits_plain): at 1k4c's 6,400 poses on 428 x 104 sub-boxes its
// (G, nR, nL, 3) float32 temporaries are 3.4 GB each, some 55 GB of device
// traffic a step for about 80 MB of bits, and it took more device time
// than the pair kernel it feeds.  This kernel goes from the boxes to the
// bits the pair kernels take, with nothing in between in device memory.
//
// For each pose, receptor tile and ligand tile, and each of 2 or 3
// cutoffs: 1 where some sub-box pair of the tile pair has a lower bound on
// its atoms' squared distance at or under the cutoff^2.  The bound is
// cull_mask_boxes': the ligand box re-centred (R c + t) and re-projected on
// the world axes (|R| h), the per-axis gap
// max(0, |c_rec - c_lig| - ((h_rec + h_lig) + slack)), and the sum of the
// squared gaps.  A box with a non-finite half extent (padding) never
// fires; neither does a pose with a NaN.  A pose whose moved flag is 0
// gets no bit.  Each cutoff's bits are written per pose, (n_r, n_l, G),
// or ORed over each 16-pose chunk, (n_r, n_l, n_chunks).
//
// Rounding: the terms are computed in the plain version's order, each
// rounded toward the side that lowers the bound (the ligand centre as an
// interval, the distance and the gap rounded down, the reach rounded up),
// so the bound never exceeds the exact bound of the float32 inputs: the
// cull is conservative, and the bits differ from the plain version's only
// where the bound lies within rounding of a cutoff^2.  No FMA, no TF32.
//
// What bounds it on this card: operations, not bytes.  At 1k4c it tests
// 2.85e8 sub-box pairs at about 35 float operations each and writes about
// 80 MB.  What the design does:
//   * one thread a pose, the 16 poses of a chunk in one half-warp, so one
//     __ballot_sync gives the chunk's OR;
//   * a block is 128 poses x one ligand tile x a group of receptor tiles
//     (at most 32 sub-boxes, one bit a tile in a 32-bit word a cutoff):
//     the group's receptor boxes sit in shared memory, and each ligand
//     sub-box is transformed once a thread and tested against all of them;
//   * the outputs are written whole (zeros too), so they need no memset;
//   * under --metrics each block writes its (pose, tile pair) entries of
//     moved poses and those the first cutoff kept to its own two words of
//     a counts buffer, which the host sums once a segment: no atomics, no
//     launch of its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // poses a block
constexpr int kChunk = 16;        // poses a chunk (POSE_BLOCK)
constexpr int kMaxBoxes = 32;     // receptor sub-boxes a block
constexpr int kMaxCuts = 3;
constexpr int kMaxGridYZ = 65535;

struct Args {
  const float* rc;        // (n_r * rg, 3) receptor sub-box centres
  const float* rh;        // (n_r * rg, 3) half extents
  const float* lc;        // (n_l * lg, 3) ligand sub-box centres, own frame
  const float* lh;        // (n_l * lg, 3)
  const float* t;         // (g, 3)
  const float* rot;       // (g, 3, 3)
  const float* slack;     // (g,) or null
  const uint8_t* moved;   // (g,) or null
  int32_t* out[kMaxCuts]; // per cutoff: (n_r, n_l, g) or (n_r, n_l, n_chunks)
  int32_t* counts;        // (blocks, 2) or null
  float cut2[kMaxCuts];
  int n_cuts, chunked;    // chunked: bit k set where cutoff k is ORed over chunks
  int g, n_chunks, n_r, n_l, rg, lg, tiles;  // tiles: receptor tiles a block
};

__device__ __forceinline__ bool finite3(const float* v) {
  return isfinite(v[0]) && isfinite(v[1]) && isfinite(v[2]);
}

__global__ void __launch_bounds__(kThreads) cull_bits_kernel(const Args a) {
  __shared__ float s_c[kMaxBoxes][3];
  __shared__ float s_h[kMaxBoxes][3];
  __shared__ unsigned s_tile[kMaxBoxes];  // the box's tile as a bit of the block's word
  __shared__ int s_sum[2][kThreads / 32];

  const int l = blockIdx.y;
  const int r0 = blockIdx.z * a.tiles;
  const int n_tiles = min(a.tiles, a.n_r - r0);
  const int n_boxes = n_tiles * a.rg;
  for (int i = threadIdx.x; i < n_boxes; i += kThreads) {
    const float* c = a.rc + 3 * (r0 * a.rg + i);
    const float* h = a.rh + 3 * (r0 * a.rg + i);
    const bool ok = finite3(h);
    s_tile[i] = 1u << (i / a.rg);
    for (int d = 0; d < 3; ++d) {
      s_c[i][d] = ok ? c[d] : 0.0f;
      s_h[i][d] = ok ? h[d] : -INFINITY;  // reach -inf: the gap is +inf
    }
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < a.g && (a.moved == nullptr || a.moved[p] != 0);
  unsigned bits[kMaxCuts] = {0u, 0u, 0u};
  if (live) {
    float R[9], T[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = a.rot[9 * p + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = a.t[3 * p + i];
    const float s = a.slack != nullptr ? a.slack[p] : 0.0f;
    for (int b = 0; b < a.lg; ++b) {
      const float* c = a.lc + 3 * (l * a.lg + b);
      const float* h = a.lh + 3 * (l * a.lg + b);
      if (!finite3(h)) continue;  // a padding box
      float lo[3], hi[3], hh[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // ((R_i0 c_0 + R_i1 c_1) + R_i2 c_2) + t_i, as an interval.
        float x = __fadd_rd(__fmul_rd(R[3 * i], c[0]), __fmul_rd(R[3 * i + 1], c[1]));
        lo[i] = __fadd_rd(__fadd_rd(x, __fmul_rd(R[3 * i + 2], c[2])), T[i]);
        x = __fadd_ru(__fmul_ru(R[3 * i], c[0]), __fmul_ru(R[3 * i + 1], c[1]));
        hi[i] = __fadd_ru(__fadd_ru(x, __fmul_ru(R[3 * i + 2], c[2])), T[i]);
        x = __fadd_ru(__fmul_ru(fabsf(R[3 * i]), h[0]), __fmul_ru(fabsf(R[3 * i + 1]), h[1]));
        hh[i] = __fadd_ru(x, __fmul_ru(fabsf(R[3 * i + 2]), h[2]));
      }
      for (int j = 0; j < n_boxes; ++j) {
        float g2[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          // |c_rec - c_lig| from below; a NaN stays a NaN through the
          // selects, so that the pose fires nowhere.
          const float below = __fsub_rd(s_c[j][i], hi[i]);
          const float above = __fsub_rd(lo[i], s_c[j][i]);
          const float dist = below > above ? below : above;
          const float reach = __fadd_ru(__fadd_ru(s_h[j][i], hh[i]), s);
          float gap = __fsub_rd(dist, reach);
          gap = gap < 0.0f ? 0.0f : gap;
          g2[i] = __fmul_rd(gap, gap);
        }
        const float d2 = __fadd_rd(__fadd_rd(g2[0], g2[1]), g2[2]);
        const unsigned tile = s_tile[j];
#pragma unroll
        for (int k = 0; k < kMaxCuts; ++k) {
          if (k < a.n_cuts && d2 <= a.cut2[k]) bits[k] |= tile;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int chunk = p / kChunk;
  for (int i = 0; i < n_tiles; ++i) {
    const size_t row = (size_t)(r0 + i) * a.n_l + l;
#pragma unroll
    for (int k = 0; k < kMaxCuts; ++k) {
      if (k >= a.n_cuts) break;
      const int bit = (bits[k] >> i) & 1;
      if (a.chunked >> k & 1) {
        const unsigned m = __ballot_sync(0xffffffffu, bit);
        if ((lane & (kChunk - 1)) == 0 && chunk < a.n_chunks) {
          a.out[k][row * a.n_chunks + chunk] = ((m >> (lane & ~(kChunk - 1))) & 0xffffu) != 0;
        }
      } else if (p < a.g) {
        a.out[k][row * a.g + p] = bit;
      }
    }
  }

  if (a.counts != nullptr) {
    int checked = live ? n_tiles : 0;
    int kept = __popc(bits[0]);
    for (int off = 16; off > 0; off >>= 1) {
      checked += __shfl_down_sync(0xffffffffu, checked, off);
      kept += __shfl_down_sync(0xffffffffu, kept, off);
    }
    if (lane == 0) {
      s_sum[0][threadIdx.x / 32] = checked;
      s_sum[1][threadIdx.x / 32] = kept;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      int total = 0;
      for (int w = 0; w < kThreads / 32; ++w) total += s_sum[threadIdx.x][w];
      const size_t block = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
      a.counts[2 * block + threadIdx.x] = total;
    }
  }
}

}  // namespace

// The blocks of a launch, for the wrapper's counts buffer: (x, y, z) of
// the grid; 0 or a CUDA error code.
extern "C" int cull_bits_grid(int g, int n_r, int n_l, int rg, int* gx, int* gy, int* gz) {
  if (g <= 0 || n_r <= 0 || n_l <= 0 || rg <= 0 || rg > kMaxBoxes) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = kMaxBoxes / rg;
  *gx = (g + kThreads - 1) / kThreads;
  *gy = n_l;
  *gz = (n_r + tiles - 1) / tiles;
  return (*gy > kMaxGridYZ || *gz > kMaxGridYZ) ? (int)cudaErrorInvalidValue : 0;
}

extern "C" int cull_bits_launch(const void* rc, const void* rh, const void* lc,
                                const void* lh, const void* t, const void* rot,
                                const void* slack, const void* moved, void* out0,
                                void* out1, void* out2, void* counts, const float* cut2,
                                int n_cuts, int chunked, int g, int n_r, int n_l, int rg,
                                int lg, void* stream) {
  int gx, gy, gz;
  int err = cull_bits_grid(g, n_r, n_l, rg, &gx, &gy, &gz);
  if (err != 0) return err;
  if (n_cuts < 1 || n_cuts > kMaxCuts || lg <= 0 || chunked < 0 || chunked >= (1 << n_cuts)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.rc = static_cast<const float*>(rc);
  a.rh = static_cast<const float*>(rh);
  a.lc = static_cast<const float*>(lc);
  a.lh = static_cast<const float*>(lh);
  a.t = static_cast<const float*>(t);
  a.rot = static_cast<const float*>(rot);
  a.slack = static_cast<const float*>(slack);
  a.moved = static_cast<const uint8_t*>(moved);
  void* outs[kMaxCuts] = {out0, out1, out2};
  for (int k = 0; k < kMaxCuts; ++k) {
    if (k < n_cuts && outs[k] == nullptr) return (int)cudaErrorInvalidValue;
    a.out[k] = static_cast<int32_t*>(outs[k]);
    a.cut2[k] = k < n_cuts ? cut2[k] : 0.0f;
  }
  a.counts = static_cast<int32_t*>(counts);
  a.n_cuts = n_cuts;
  a.chunked = chunked;
  a.g = g;
  a.n_chunks = (g + kChunk - 1) / kChunk;
  a.n_r = n_r;
  a.n_l = n_l;
  a.rg = rg;
  a.lg = lg;
  a.tiles = kMaxBoxes / rg;
  cull_bits_kernel<<<dim3(gx, gy, gz), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Registers a thread and static shared memory a block, and the blocks an
// SM holds, for the smoke run's report; 0 or a CUDA error code.
extern "C" int cull_bits_occupancy(int* blocks_per_sm, int* regs, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)cull_bits_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, cull_bits_kernel,
                                                             kThreads, 0);
}
