// DFIRE step-form pair kernel (K4) for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_dfire_kernel (the v1 kernel
// of dfire_pairs_pallas).  For every pose: the raw sum over receptor x
// ligand atom pairs with d2 <= cutoff2 of
//   dq[0][i][j] + sum_k dq[k][i][j] * [d2 >= s_k]
// from the (K, Nr, Nl) step tables, plus per-atom interface flags at
// d2 <= iface2.  Every (receptor tile, ligand tile, pose) has its own cull
// bit and interface bit; a pose is scored on a tile only where its cull bit
// is 1, and flagged only where both are.  The receptor is rigid (one copy
// for all poses) or per pose (receptor ANM).
//
// What bounds it on this card: issuing the per-pair-pose instructions (d2,
// the bin, a shared-memory load, the add), provided each pair's K channels
// come from device memory about once a call: the tables are K x Nr x Nl
// values (30 MB at 1ppe's 1615 x 221 atoms with 21 channels).  The TPU
// kernel kept a tile's channels in VMEM (21 x 32 x 128 x 4 B = 344 KB) and
// looped over every pose; an SM has 227 KB of shared memory.  What the
// design does (the layout of K1's body, csrc/dfire_pairs.cu, with the
// pair's value read from shared memory instead of a table in L2):
//   * one block of 256 threads per (receptor tile of up to 32 rows, 16
//     ligand atoms, group of 16-pose chunks); before its chunks it reads
//     its pairs' channels once and keeps their prefix sums in shared
//     memory, formed in float in channel order (the select chain's
//     addition order, so each pair's value is bit-equal to the chain's):
//     K planes [channel][pair] of 527 words at 32 rows (21 channels: 43 KB,
//     4 blocks an SM).  The price is 14 partial rows a receptor tile for
//     the second pass to add, against K1's 2;
//   * lanes over poses: the 16 lanes of a half-warp hold the 16 poses of
//     the chunk for one ligand atom, the two half-warps two atoms, so a
//     warp's lanes share one receptor row.  A half-warp reads one pair at
//     up to 16 channels: the plane stride is 15 modulo 32 banks, so the
//     channels fall in distinct banks (and the other half-warp's pair, one
//     word on, collides only at channels 15 apart).  Each lane keeps its
//     pose's sum in a register over the block's rows, and the sums are
//     reduced once a chunk in a fixed order (the half-warps, then the warps
//     in order) into the block's partial row.  A pose's cull bit is a
//     per-lane predicate; a chunk with no pose's bit set is skipped;
//   * the bin comes from the distance, as in K1: LightDock's 0.5 A slot
//     m = trunc(2 sqrt.approx(d2) (1 + 2^-16) - 1), one compare against
//     the exact edge ((m + 1) / 2)^2, then the slot's channel from
//     slot_bin (ops.dfire_pairs.slot_bins: the count of thresholds after
//     the first at or below the slot's edge, which is the largest c with
//     s_c <= d2).  It replaces a 5-step binary search over the thresholds,
//     five dependent shared loads.  The wrapper refuses thresholds off the
//     slot grid, where slot and threshold count would part.  Every pair
//     takes this path without a branch (past the cutoff the value is
//     dropped by a select): 29 instructions a rigid pair-pose, where a
//     branch around it, with its convergence barrier and the addresses
//     rebuilt inside it, took 39 (PERF.md);
//   * the receptor tile in shared memory: one float4 a row read as a
//     broadcast, or, per pose, planes [x|y|z][row][pose] for the chunk;
//   * interface hits stay in registers (a 32-bit row mask and the ligand
//     atom's flag a thread), stored after the rows and only for the hits;
//   * the poses go over blocks as the grid's first dimension, so the grid
//     has several waves of blocks and no long tail: each pose group
//     re-reads its pairs' channels, from L2 (50 MB) after the first.  The
//     chunks a block (chunks_per_block below) are chosen from the card's
//     resident blocks, queried once a kernel and device: on the H100 7 at
//     G = 200, where one a block pays 13 fills, and 67 at 6,400 poses,
//     where all 400 in one block leave a long last wave (the A/B of these
//     counts is in PERF.md);
//   * sums are deterministic: no float atomics.  Each block writes its
//     per-pose sums to its partial row; a second kernel adds the rows in
//     order (sum_rows.cuh).
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
// Atoms past the true counts (nr, nl) are padding and are skipped: the
// inputs are not padded.  bfloat16 step tables are upcast element by
// element before the adds.
//
// d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with explicit round-to-nearest
// intrinsics: no contraction into FMA, so d2 is bit-equal to the plain
// PyTorch version and no pair moves across a bin edge between the two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "sum_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 16;          // poses per chunk: the lanes of a half-warp
constexpr int kLig = 16;            // ligand atoms a block: two a warp
constexpr int kMaxRows = 32;        // receptor rows a block: one bit of a row mask each
constexpr int kMaxChannels = 32;
constexpr int kMaxSlots = 32;       // slot_bin entries
constexpr int kMinBlocks = 4;       // 4 x 256 threads an SM: at most 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kTargetWaves = 8;     // blocks of a launch, in resident blocks of the card
constexpr int kMinChunks = 7;       // chunks a block at least: the prefix-sum fill's share
                                    // (7 beat 4 and 13 at G = 200: PERF.md)

struct SlotBins {
  int v[kMaxSlots];  // v[m + 1]: the channel of slot m (m = -1 .. n_slots - 2)
};

struct Inputs {
  const float* rec;          // (1 | g, nr, 3)
  const float* lig;          // (g, 3, nl)
  const int32_t* act;        // (n_r, n_l, g)
  const int32_t* iface_act;  // (n_r, n_l, g)
  float* ifr;                // (g, nr_pad) or null
  float* ifl;                // (g, nl_pad) or null
  int nr, nl, nr_pad, nl_pad, g, r_tile, l_tile, n_l, n_k, stride, n_chunks,
      chunks_per_block;
  float cutoff2, iface2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Words between two channel planes of the prefix sums: at least the block's
// pairs, and 15 modulo the 32 banks.
__host__ __device__ inline int plane_stride(int r_tile) {
  return (r_tile * kLig + 31) / 32 * 32 + 15;
}

// The rows of one ligand atom for one pose: adds each in-cutoff pair's
// prefix sum at its channel to acc; with kIface, sets bit i of rmask where
// row i is within the interface cutoff.  cum points at the ligand atom's
// column of channel 0 (pair i sits i * kLig words on), s_plane[m + 1] is
// the offset of slot m's channel plane.
template <bool kPerPose, bool kIface>
__device__ __forceinline__ void ligand_rows(const Inputs& in, const float4* s_rec4,
                                            const float* s_pp, const int* s_plane,
                                            const float* cum, int n_rows, int p, float lx,
                                            float ly, float lz, float& acc, unsigned& rmask) {
#pragma unroll 4
  for (int i = 0; i < n_rows; ++i) {
    float rx, ry, rz;
    if (kPerPose) {
      rx = s_pp[(0 * kMaxRows + i) * kPoses + p];
      ry = s_pp[(1 * kMaxRows + i) * kPoses + p];
      rz = s_pp[(2 * kMaxRows + i) * kPoses + p];
    } else {
      const float4 v = s_rec4[i];
      rx = v.x;
      ry = v.y;
      rz = v.z;
    }
    const float dx = __fsub_rn(lx, rx);
    const float dy = __fsub_rn(ly, ry);
    const float dz = __fsub_rn(lz, rz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    // Every pair takes the slot's path, without a branch: past the cutoff
    // (or at a NaN) any slot in the table will do, and the value is dropped.
    float s;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(d2));
    // 2 s (1 + 2^-16) - 1: never below the exact slot, at most one above.
    int m = __float2int_rz(__fmaf_rn(s, 2.0f + 0x1p-15f, -1.0f));
    const float edge = __fmaf_rn(__int2float_rn(m), 0.5f, 0.5f);   // (m + 1) / 2
    if (d2 < __fmul_rn(edge, edge)) --m;
    const float v = cum[s_plane[min(m, kMaxSlots - 2) + 1] + i * kLig];
    acc = __fadd_rn(acc, d2 <= in.cutoff2 ? v : 0.0f);   // acc is never -0: + 0 keeps it
    if (kIface && d2 <= in.iface2) rmask |= 1u << i;
  }
}

// Grid (pose groups, ligand blocks of kLig atoms, receptor tiles); partial
// row = blockIdx.z * gridDim.y + blockIdx.y.
template <typename T, bool kPerPose>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dfire_pairs_v1_kernel(Inputs in, SlotBins sb, const T* __restrict__ dq,
                      float* __restrict__ partial) {
  extern __shared__ float s_cum[];                                  // [n_k][stride]
  __shared__ float4 s_rec4[kPerPose ? 1 : kMaxRows];                // x, y, z, -
  __shared__ float s_pp[kPerPose ? 3 * kMaxRows * kPoses : 1];      // [xyz][row][pose]
  __shared__ unsigned s_rhits[2][kPoses];   // bit i: row i hit, by pose; by chunk parity
  __shared__ int s_plane[kMaxSlots];   // slot m's channel plane at s_plane[m + 1]
  __shared__ float s_red[kWarps][kPoses];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.z * in.r_tile;
  const int j0 = blockIdx.y * kLig;
  const int n_rows = min(in.r_tile, in.nr - r0);
  const int tile = blockIdx.z * in.n_l + j0 / in.l_tile;
  float* part = partial + (size_t)(blockIdx.z * gridDim.y + blockIdx.y) * in.g;

  // The block's pairs' prefix sums, each channel read once, in channel
  // order; pair q is (row q / kLig, atom q % kLig).
  const size_t plane = (size_t)in.nr * in.nl;
  for (int q = tid; q < n_rows * kLig; q += kThreads) {
    const int j = j0 + q % kLig;
    if (j >= in.nl) continue;
    const T* src = dq + (size_t)(r0 + q / kLig) * in.nl + j;
    float acc = to_float(src[0]);
    s_cum[q] = acc;
#pragma unroll 4
    for (int c = 1; c < in.n_k; ++c) {
      acc = __fadd_rn(acc, to_float(src[c * plane]));
      s_cum[c * in.stride + q] = acc;
    }
  }
  if (!kPerPose && tid < n_rows) {
    const float* q = in.rec + (size_t)(r0 + tid) * 3;
    s_rec4[tid] = make_float4(q[0], q[1], q[2], 0.0f);
  }
  if (tid < kMaxSlots) s_plane[tid] = sb.v[tid] * in.stride;

  // Thread -> (pose 16 c + p, ligand atom j0 + jl).
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = lane & (kPoses - 1);
  const int jl = 2 * warp + (lane >> 4);
  const int j = j0 + jl;
  const bool j_ok = j < in.nl;
  const float* cum = s_cum + jl;
  const int32_t* act = in.act + (size_t)tile * in.g;
  const int32_t* iface_act = in.iface_act + (size_t)tile * in.g;
  const bool want_iface = in.ifr != nullptr;

  const int c_begin = blockIdx.x * in.chunks_per_block;
  const int c_end = min(c_begin + in.chunks_per_block, in.n_chunks);
  for (int c = c_begin; c < c_end; ++c) {
    const int c0 = c * kPoses;
    const int pose = c0 + p;
    const bool pose_ok = pose < in.g;
    const bool on = pose_ok && act[pose] != 0;
    const bool on_iface = on && want_iface && iface_act[pose] != 0;
    unsigned* rhits = s_rhits[c & 1];   // last read two chunks ago
    if (tid < kPoses) rhits[tid] = 0u;
    if (kPerPose) {
      // Read in the source order; s_pp[(x * 32 + i) * 16 + q] = rec[c0 + q][r0 + i][x].
      const int per_pose = n_rows * 3;
      for (int e = tid; e < kPoses * per_pose; e += kThreads) {
        const int q = e / per_pose;
        const int rest = e - q * per_pose;
        const int i = rest / 3;
        const int x = rest - i * 3;
        if (c0 + q < in.g) {
          s_pp[(x * kMaxRows + i) * kPoses + q] =
              in.rec[((size_t)(c0 + q) * in.nr + r0) * 3 + rest];
        }
      }
    }
    if (!__syncthreads_or(on)) {   // no pose of the chunk is scored here
      if (tid < kPoses && c0 + tid < in.g) part[c0 + tid] = 0.0f;
      continue;
    }
    const bool do_iface = want_iface && __syncthreads_or(on_iface);

    float acc = 0.0f;
    unsigned rmask = 0u;   // bit i: receptor row i within the interface cutoff
    if (on && j_ok) {
      const float* lp = in.lig + (size_t)pose * 3 * in.nl + j;
      const float lx = __ldg(lp);
      const float ly = __ldg(lp + in.nl);
      const float lz = __ldg(lp + 2 * in.nl);
      if (do_iface) {
        ligand_rows<kPerPose, true>(in, s_rec4, s_pp, s_plane, cum, n_rows, p, lx, ly, lz,
                                    acc, rmask);
        if (!on_iface) rmask = 0u;
        if (rmask != 0u) {
          in.ifl[(size_t)pose * in.nl_pad + j] = 1.0f;
          atomicOr(&rhits[p], rmask);
        }
      } else {
        ligand_rows<kPerPose, false>(in, s_rec4, s_pp, s_plane, cum, n_rows, p, lx, ly, lz,
                                     acc, rmask);
      }
    }

    // Fixed-order block reduction of the chunk's 16 per-pose sums: the two
    // half-warps (a + b == b + a exactly), then the warps in order.
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, kPoses));
    if (lane < kPoses) s_red[warp][lane] = acc;
    __syncthreads();
    if (tid < kPoses && c0 + tid < in.g) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_red[w][tid]);
      part[c0 + tid] = s;
    }
    if (do_iface) {  // receptor flags, consecutive rows on consecutive threads
      for (int e = tid; e < kPoses * n_rows; e += kThreads) {
        const int q = e / n_rows;
        const int i = e - q * n_rows;
        if ((rhits[q] >> i) & 1u) in.ifr[(size_t)(c0 + q) * in.nr_pad + r0 + i] = 1.0f;
      }
    }
  }
}

template <typename T, bool kPerPose>
const void* kernel_of() {
  return (const void*)dfire_pairs_v1_kernel<T, kPerPose>;
}

const void* pick(int dq_bf16, int per_pose) {
  if (dq_bf16) {
    return per_pose ? kernel_of<__nv_bfloat16, true>() : kernel_of<__nv_bfloat16, false>();
  }
  return per_pose ? kernel_of<float, true>() : kernel_of<float, false>();
}

size_t dynamic_smem(int n_k, int r_tile) {
  return (size_t)n_k * plane_stride(r_tile) * sizeof(float);
}

// A kernel's resident blocks an SM on one device, with one dynamic shared
// memory size, and that device's SM count.
struct Residency {
  int device;
  const void* kernel;
  size_t smem;
  int blocks_per_sm;
  int sms;
};

std::mutex g_residency_mu;
std::vector<Residency> g_residency;

// The residency of kernel with smem bytes of dynamic shared memory on the
// current device, found the first time only: it does not change between
// launches.  The kernel's allowance of dynamic shared memory above 48 KB
// is one setting a device, which only grows (to the most any launch has
// asked), so every size seen before stays allowed.  0 or a CUDA error.
int residency(const void* kernel, size_t smem, Residency* out) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(g_residency_mu);
  size_t allowed = 0;
  for (const Residency& r : g_residency) {
    if (r.device != device || r.kernel != kernel) continue;
    if (r.smem == smem) {
      *out = r;
      return 0;
    }
    allowed = std::max(allowed, r.smem);
  }
  Residency r{device, kernel, smem, 0, 0};
  if (smem > allowed) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.blocks_per_sm, kernel, kThreads, smem);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  g_residency.push_back(r);
  *out = r;
  return 0;
}

// The chunks of 16 poses a block: the fewest that give a grid of about
// kTargetWaves times the blocks the card holds at once (so the last wave
// is a small share of the call), spread evenly, but at least kMinChunks
// (so the prefix-sum fill stays a small share of a block) and at most
// every chunk.
int chunks_per_block(const Residency& r, int g, int nr, int nl, int r_tile) {
  const long long base = (long long)((nr + r_tile - 1) / r_tile) * ((nl + kLig - 1) / kLig);
  const long long target = (long long)kTargetWaves * r.blocks_per_sm * r.sms;
  const int n_chunks = (g + kPoses - 1) / kPoses;
  const long long groups = std::min<long long>(std::max<long long>((target + base - 1) / base, 1),
                                               n_chunks);
  return std::min(std::max((int)((n_chunks + groups - 1) / groups), kMinChunks), n_chunks);
}

}  // namespace

extern "C" int dfire_pairs_v1_launch(
    const void* rec, const void* lig, const void* dq, const void* act,
    const void* iface_act, void* partial, void* raw, void* ifr, void* ifl,
    int nr, int nl, int nr_pad, int nl_pad, int g, int rec_poses, int r_tile,
    int l_tile, int dq_bf16, int need_iface, const int32_t* slot_bin, int n_slots,
    int n_k, float cutoff2, float iface2, void* stream) {
  if (r_tile <= 0 || r_tile > kMaxRows || l_tile <= 0 || l_tile % kLig != 0 ||
      nr_pad % r_tile != 0 || nl_pad % l_tile != 0 || nr < 1 || nl < 1 || nr > nr_pad ||
      nl > nl_pad || g < 1 || n_k < 1 || n_k > kMaxChannels || n_slots < 1 ||
      n_slots > kMaxSlots || (rec_poses != 1 && rec_poses != g) ||
      (need_iface && (ifr == nullptr || ifl == nullptr)) ||
      !(cutoff2 <= 0.25f * (n_slots - 1) * (n_slots - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  SlotBins sb;
  for (int s = 0; s < kMaxSlots; ++s) {
    sb.v[s] = slot_bin[s < n_slots ? s : n_slots - 1];
    if (sb.v[s] < 0 || sb.v[s] >= n_k) return (int)cudaErrorInvalidValue;
  }
  const int per_pose = rec_poses != 1;
  const void* kernel = pick(dq_bf16, per_pose);
  const size_t smem = dynamic_smem(n_k, r_tile);
  Residency res;
  const int err = residency(kernel, smem, &res);
  if (err != 0) return err;
  const int n_chunks = (g + kPoses - 1) / kPoses;
  const int cpb = chunks_per_block(res, g, nr, nl, r_tile);
  const Inputs in{static_cast<const float*>(rec), static_cast<const float*>(lig),
                  static_cast<const int32_t*>(act), static_cast<const int32_t*>(iface_act),
                  need_iface ? static_cast<float*>(ifr) : nullptr,
                  need_iface ? static_cast<float*>(ifl) : nullptr,
                  nr, nl, nr_pad, nl_pad, g, r_tile, l_tile, nl_pad / l_tile, n_k,
                  plane_stride(r_tile), n_chunks, cpb, cutoff2, iface2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_chunks + cpb - 1) / cpb,
                  (nl + kLig - 1) / kLig, (nr + r_tile - 1) / r_tile);
  float* f_part = static_cast<float*>(partial);
  if (dq_bf16) {
    const auto* d = static_cast<const __nv_bfloat16*>(dq);
    if (per_pose) {
      dfire_pairs_v1_kernel<__nv_bfloat16, true><<<grid, kThreads, smem, s>>>(in, sb, d, f_part);
    } else {
      dfire_pairs_v1_kernel<__nv_bfloat16, false><<<grid, kThreads, smem, s>>>(in, sb, d, f_part);
    }
  } else {
    const auto* d = static_cast<const float*>(dq);
    if (per_pose) {
      dfire_pairs_v1_kernel<float, true><<<grid, kThreads, smem, s>>>(in, sb, d, f_part);
    } else {
      dfire_pairs_v1_kernel<float, false><<<grid, kThreads, smem, s>>>(in, sb, d, f_part);
    }
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), grid.y * grid.z, g, s);
}

// Occupancy of K4 for the smoke run's report.  which: 0 rigid, 1 per-pose
// receptor, each with float32 (+ 2: bfloat16) step tables; n_k channels
// and r_tile rows set the dynamic shared memory.  Fills the blocks of
// kThreads an SM can hold, the registers and local (stack and spill) bytes
// a thread and the static shared memory a block; 0 or a CUDA error code.
extern "C" int dfire_pairs_v1_occupancy(int which, int n_k, int r_tile, int* blocks_per_sm,
                                        int* regs, int* local_bytes, int* smem_bytes) {
  if (which < 0 || which > 3 || n_k < 1 || n_k > kMaxChannels || r_tile < 1 ||
      r_tile > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kernel = pick(which >= 2, which & 1);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  Residency res;
  const int err = residency(kernel, dynamic_smem(n_k, r_tile), &res);
  if (err != 0) return err;
  *blocks_per_sm = res.blocks_per_sm;
  return 0;
}
