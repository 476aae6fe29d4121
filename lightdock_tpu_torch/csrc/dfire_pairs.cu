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
// What bounds the body on this card: not bytes (a 16-pose chunk's
// coordinates are a few KB and the table stays in L2) but issuing the
// per-pair-pose instructions (d2, the bin, the table load, the add, the
// interface compare) and hiding the loads' latency behind other warps.
// What the design does:
//   * lanes over poses: the 16 lanes of a half-warp hold the 16 poses of
//     the chunk for one ligand atom, so a warp's 32 lanes share one
//     receptor atom and two ligand atoms.  A warp's table load then reads
//     at most two 128-byte rows (one atom pair's bins each), where a warp
//     of 32 ligand atoms read one row a distinct ligand type;
//   * one pose's coordinates a thread, not 16 poses', and the launch
//     bounds hold the body to 32 registers: 64 resident warps an SM (the
//     most there is) to hide the table loads, where the 16-pose layout
//     took 120-127 registers and 16 warps.  The pose's sum is reduced in
//     a fixed order: the two half-warps, then the block's warps in order;
//   * the table is indexed by the receptor atom's row class (atoms of one
//     DFIRE type share a row), cum[rec_type][lig_type][bin]: about 4 MB,
//     which stays in the 50 MB L2 where a per-atom table (37 MB at 1ppe,
//     78 MB at 1k4c) did not.  Offsets are 32-bit: one wide multiply-add
//     makes the address;
//   * the bin comes from the distance, LightDock's 0.5 A slot
//     m = trunc(2 sqrt(d2) - 1), then slot_bin[m + 1], the live bin of
//     that slot, from shared memory (31 words in 31 banks, so lanes never
//     conflict; kernel parameter space would serialise lanes reading
//     different entries).  It replaces a 5-step binary search over the
//     thresholds, five dependent shared loads.  The sqrt is the hardware
//     approximation, sqrt.approx.ftz.f32: one instruction, whose maximum
//     relative error over the whole range the PTX ISA gives as 2^-23
//     (section "sqrt"), a few ulps.  Scaled up by 2^-16, far more than
//     that, m is never below the exact slot and at most one above it for
//     any sqrt within 64 ulps of the exact one, and one compare against
//     the exact edge ((m + 1) / 2)^2 takes it back where it is above.  A
//     correctly rounded sqrt would need the same compare (it rounds up
//     onto an edge from 1 ulp below it) and is a longer sequence that
//     made K1 and K2 23-24% slower on the H100 (PERF.md).  The CPU tests
//     model the slot for any sqrt within 64 ulps; the smoke run and the
//     cuda tests hold the kernels to plain at every edge +-64 ulps.  The
//     wrapper accepts only thresholds on the slot grid, where slot and
//     threshold count give the same bin.  Chunks whose near bit is 0 take
//     max(bin, split), as the TPU kernel's far subtree did;
//   * the receptor tile (32 rows) sits in shared memory: one float4 a row
//     (x, y, z and the row's table offset) read as a broadcast, or, per
//     pose, planes [x|y|z][row][pose], where 16 lanes read 16 consecutive
//     words;
//   * interface hits stay in registers: a thread ORs its pose's hits into
//     a 32-bit row mask and its ligand atom's into a flag, then stores the
//     atom's flag after its rows and ORs the row mask into its pose's
//     shared word once; the receptor flags are stored after the loop, only
//     for the rows and poses hit;
//   * sums are deterministic: no float atomics.  Each block writes its
//     per-pose sums to its partial row; a second kernel adds the rows in
//     order (sum_rows.cuh).
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
//
// d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with explicit round-to-nearest
// intrinsics: no contraction into FMA, so d2 is bit-equal to the plain
// PyTorch version and no pair moves across a bin edge between the two.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sum_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 16;                  // poses per chunk (POSE_BLOCK)
constexpr int kLigPerPass = kThreads / kPoses;  // ligand atoms a block pass
constexpr int kMaxSlots = 32;               // slot_bin entries
constexpr int kMaxRTile = 32;               // receptor rows: one bit of a row mask each
constexpr int kMinBlocks = 8;               // 8 x 256 threads: 32 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kCompactThreads = 1024;
constexpr int kMaxGridY = 65535;

struct SlotBins {
  int v[kMaxSlots];  // v[m + 1]: the live bin of slot m (m = -1 .. n_slots - 2)
};

struct Inputs {
  const float* rec;         // (1 | gp, nr_pad, 3)
  const float* lig;         // (gp, 3, nl_pad)
  const float* cum;         // (n_rec_types, t1, kp)
  const int32_t* rec_type;  // (nr_pad,)
  const int32_t* lig_type;  // (nl_pad,)
  const int32_t* act;       // (n_r, n_l, n_chunks)
  const int32_t* iface_act; // (n_r, n_l, gp)
  const int32_t* near;      // (n_r, n_l, n_chunks) or null
  float* ifr;               // (gp, nr_pad) or null
  float* ifl;               // (gp, nl_pad) or null
  int nr_pad, nl_pad, gp, r_tile, l_tile, t1, kp, split, n_l, n_chunks;
  float cutoff2, iface2;
};

// The rows of one ligand atom for one pose: adds each in-cutoff pair's
// table entry to acc; with kIface, sets bit i of rmask where row i is
// within the interface cutoff and returns whether any row was.
template <bool kPerPose, bool kIface>
__device__ __forceinline__ bool ligand_rows(const Inputs& in, const float4* s_rec4,
                                            const float* s_pp, const unsigned* s_roff,
                                            const int* s_slot, int p, float lx, float ly,
                                            float lz, unsigned lig_off, int k_lo,
                                            float& acc, unsigned& rmask) {
  const int r_tile = in.r_tile;
  bool lhit = false;
#pragma unroll 4
  for (int i = 0; i < r_tile; ++i) {
    float rx, ry, rz;
    unsigned roff;
    if (kPerPose) {
      rx = s_pp[(0 * kMaxRTile + i) * kPoses + p];
      ry = s_pp[(1 * kMaxRTile + i) * kPoses + p];
      rz = s_pp[(2 * kMaxRTile + i) * kPoses + p];
      roff = s_roff[i];
    } else {
      const float4 v = s_rec4[i];
      rx = v.x;
      ry = v.y;
      rz = v.z;
      roff = __float_as_uint(v.w);
    }
    const float dx = __fsub_rn(lx, rx);
    const float dy = __fsub_rn(ly, ry);
    const float dz = __fsub_rn(lz, rz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (d2 <= in.cutoff2) {
      float s;
      asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(d2));
      // 2 s (1 + 2^-16) - 1: never below the exact slot, at most one above.
      int m = __float2int_rz(__fmaf_rn(s, 2.0f + 0x1p-15f, -1.0f));
      const float edge = __fmaf_rn(__int2float_rn(m), 0.5f, 0.5f);   // (m + 1) / 2
      if (d2 < __fmul_rn(edge, edge)) --m;
      const unsigned b = (unsigned)max(s_slot[m + 1], k_lo);
      acc = __fadd_rn(acc, __ldg(in.cum + (lig_off + roff + b)));
    }
    if (kIface && d2 <= in.iface2) {
      lhit = true;
      rmask |= 1u << i;
    }
  }
  return lhit;
}

// One (receptor tile r, ligand tile l, pose chunk c); writes the chunk's
// 16 per-pose sums to part[0..15].
template <bool kPerPose>
__device__ __forceinline__ void tile_body(const Inputs& in, const SlotBins& sb,
                                          int r, int l, int c, float* part) {
  __shared__ float4 s_rec4[kPerPose ? 1 : kMaxRTile];            // x, y, z, offset
  __shared__ float s_pp[kPerPose ? 3 * kMaxRTile * kPoses : 1];  // [xyz][row][pose]
  __shared__ unsigned s_roff[kPerPose ? kMaxRTile : 1];
  __shared__ unsigned s_rhits[kPoses];   // bit i: receptor row i hit, by pose
  __shared__ int s_slot[kMaxSlots];
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
  // Far chunk: no pair is nearer than the split's threshold, so bins start
  // there, and no pair can be inside the interface cutoff.
  const int k_lo = is_near ? 0 : in.split;

  const int r_tile = in.r_tile;
  const int r0 = r * r_tile;
  const int l0 = l * in.l_tile;
  const unsigned row_stride = (unsigned)(in.t1 * in.kp);
  if (kPerPose) {
    // Read in the source order; s_pp[(x * 32 + i) * 16 + p] = rec[c0 + p][r0 + i][x].
    for (int e = tid; e < kPoses * r_tile * 3; e += kThreads) {
      const int p = e / (r_tile * 3);
      const int rest = e - p * r_tile * 3;
      const int i = rest / 3;
      const int x = rest - i * 3;
      s_pp[(x * kMaxRTile + i) * kPoses + p] =
          in.rec[((size_t)(c0 + p) * in.nr_pad + r0) * 3 + rest];
    }
    if (tid < r_tile) s_roff[tid] = (unsigned)in.rec_type[r0 + tid] * row_stride;
  } else if (tid < r_tile) {
    const float* q = in.rec + (size_t)(r0 + tid) * 3;
    s_rec4[tid] = make_float4(q[0], q[1], q[2],
                              __uint_as_float((unsigned)in.rec_type[r0 + tid] * row_stride));
  }
  if (tid < kMaxSlots) s_slot[tid] = sb.v[tid];
  if (tid < kPoses) s_rhits[tid] = 0u;
  __syncthreads();

  // Thread -> (pose c0 + p, ligand atoms j = 2 * warp + half + 16 s); the
  // wrapper makes l_tile a multiple of 16, so every lane of a warp runs the
  // same atoms' rows.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = lane & (kPoses - 1);
  const size_t pose = (size_t)(c0 + p);
  float acc = 0.0f;
  unsigned rmask = 0u;   // bit i: receptor row i within the interface cutoff
  for (int j = 2 * warp + (lane >> 4); j < in.l_tile; j += kLigPerPass) {
    const float* lp = in.lig + pose * 3 * in.nl_pad + l0 + j;
    const float lx = __ldg(lp);
    const float ly = __ldg(lp + in.nl_pad);
    const float lz = __ldg(lp + 2 * in.nl_pad);
    const unsigned lig_off = (unsigned)(in.lig_type[l0 + j] * in.kp);
    if (do_iface) {
      if (ligand_rows<kPerPose, true>(in, s_rec4, s_pp, s_roff, s_slot, p, lx, ly, lz,
                                      lig_off, k_lo, acc, rmask)) {
        in.ifl[pose * in.nl_pad + l0 + j] = 1.0f;
      }
    } else {
      ligand_rows<kPerPose, false>(in, s_rec4, s_pp, s_roff, s_slot, p, lx, ly, lz,
                                   lig_off, k_lo, acc, rmask);
    }
  }
  if (rmask != 0u) atomicOr(&s_rhits[p], rmask);

  // Fixed-order block reduction of the 16 per-pose sums: the two
  // half-warps (a + b == b + a exactly), then the warps in order.
  acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, kPoses));
  if (lane < kPoses) s_red[warp][lane] = acc;
  __syncthreads();
  if (tid < kPoses) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_red[w][tid]);
    part[tid] = s;
  }
  if (do_iface) {  // receptor flags, consecutive rows on consecutive threads
    for (int e = tid; e < kPoses * r_tile; e += kThreads) {
      const int q = e / r_tile;
      const int i = e - q * r_tile;
      if ((s_rhits[q] >> i) & 1u) in.ifr[(size_t)(c0 + q) * in.nr_pad + r0 + i] = 1.0f;
    }
  }
}

// K1: grid (n_chunks, n_l, n_r); partial row = tile.
template <bool kPerPose>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dfire_pairs_kernel(Inputs in, SlotBins sb, float* __restrict__ partial) {
  const int c = blockIdx.x, l = blockIdx.y, r = blockIdx.z;
  tile_body<kPerPose>(in, sb, r, l, c,
                      partial + (size_t)(r * in.n_l + l) * in.gp + c * kPoses);
}

// K2: grid (n_chunks, n_tiles); partial row = list slot.
template <bool kPerPose>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dfire_pairs_worklist_kernel(Inputs in, SlotBins sb,
                            const int32_t* __restrict__ worklist,
                            const int32_t* __restrict__ n_active,
                            float* __restrict__ partial) {
  const int c = blockIdx.x, slot = blockIdx.y;
  if (slot >= *n_active) return;
  const int tile = worklist[slot];
  tile_body<kPerPose>(in, sb, tile / in.n_l, tile % in.n_l, c,
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

// Checks the shapes and fills in and sb; 0 or a CUDA error code.
int prepare(const void* rec, const void* lig, const void* cum, const void* rec_type,
            const void* lig_type, const void* act, const void* iface_act,
            const void* near, void* ifr, void* ifl, int nr_pad, int nl_pad, int gp,
            int rec_poses, int r_tile, int l_tile, int t1, int kp,
            const int32_t* slot_bin, int n_slots, int n_k, int split,
            float cutoff2, float iface2, Inputs* in, SlotBins* sb) {
  if (r_tile <= 0 || r_tile > kMaxRTile || l_tile <= 0 || l_tile % kLigPerPass != 0 ||
      n_k < 1 || n_k > kp || n_slots < 1 || n_slots > kMaxSlots || split < 0 ||
      split >= n_k || nr_pad % r_tile != 0 || nl_pad % l_tile != 0 ||
      gp % kPoses != 0 || (rec_poses != 1 && rec_poses != gp) ||
      !(cutoff2 <= 0.25f * (n_slots - 1) * (n_slots - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < kMaxSlots; ++s) {
    sb->v[s] = slot_bin[s < n_slots ? s : n_slots - 1];
    if (sb->v[s] < 0 || sb->v[s] >= n_k) return (int)cudaErrorInvalidValue;
  }
  *in = Inputs{static_cast<const float*>(rec), static_cast<const float*>(lig),
               static_cast<const float*>(cum), static_cast<const int32_t*>(rec_type),
               static_cast<const int32_t*>(lig_type), static_cast<const int32_t*>(act),
               static_cast<const int32_t*>(iface_act), static_cast<const int32_t*>(near),
               static_cast<float*>(ifr), static_cast<float*>(ifl), nr_pad, nl_pad, gp,
               r_tile, l_tile, t1, kp, split, nl_pad / l_tile, gp / kPoses, cutoff2,
               iface2};
  return 0;
}

}  // namespace

extern "C" int dfire_pairs_launch(
    const void* rec, const void* lig, const void* cum, const void* rec_type,
    const void* lig_type, const void* act, const void* iface_act, const void* near,
    void* partial, void* raw, void* ifr, void* ifl, int nr_pad, int nl_pad, int gp,
    int rec_poses, int r_tile, int l_tile, int t1, int kp, const int32_t* slot_bin,
    int n_slots, int n_k, int split, float cutoff2, float iface2, void* stream) {
  Inputs in;
  SlotBins sb;
  int err = prepare(rec, lig, cum, rec_type, lig_type, act, iface_act, near, ifr, ifl,
                    nr_pad, nl_pad, gp, rec_poses, r_tile, l_tile, t1, kp, slot_bin,
                    n_slots, n_k, split, cutoff2, iface2, &in, &sb);
  if (err != 0) return err;
  const int n_r = nr_pad / r_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(in.n_chunks, in.n_l, n_r);
  float* f_part = static_cast<float*>(partial);
  if (rec_poses == 1) {
    dfire_pairs_kernel<false><<<grid, kThreads, 0, s>>>(in, sb, f_part);
  } else {
    dfire_pairs_kernel<true><<<grid, kThreads, 0, s>>>(in, sb, f_part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), n_r * in.n_l, gp, s);
}

extern "C" int dfire_pairs_worklist_launch(
    const void* rec, const void* lig, const void* cum, const void* rec_type,
    const void* lig_type, const void* act, const void* iface_act, const void* near,
    void* worklist, void* n_active, void* partial, void* raw, void* ifr, void* ifl,
    int nr_pad, int nl_pad, int gp, int rec_poses, int r_tile, int l_tile, int t1,
    int kp, const int32_t* slot_bin, int n_slots, int n_k, int split, float cutoff2,
    float iface2, void* stream) {
  Inputs in;
  SlotBins sb;
  int err = prepare(rec, lig, cum, rec_type, lig_type, act, iface_act, near, ifr, ifl,
                    nr_pad, nl_pad, gp, rec_poses, r_tile, l_tile, t1, kp, slot_bin,
                    n_slots, n_k, split, cutoff2, iface2, &in, &sb);
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
    dfire_pairs_worklist_kernel<false><<<grid, kThreads, 0, s>>>(in, sb, wl, n_act, f_part);
  } else {
    dfire_pairs_worklist_kernel<true><<<grid, kThreads, 0, s>>>(in, sb, wl, n_act, f_part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, n_act, static_cast<float*>(raw), 0, gp, s);
}

// Occupancy of K1 and K2 for the smoke run's report.  which: 0 K1 rigid,
// 1 K1 per pose, 2 K2 rigid, 3 K2 per pose.  Fills the blocks of kThreads
// an SM can hold, the registers a thread and the static shared memory a
// block; 0 or a CUDA error code.
extern "C" int dfire_pairs_occupancy(int which, int* blocks_per_sm, int* regs,
                                     int* smem_bytes) {
  const void* kernels[4] = {(const void*)dfire_pairs_kernel<false>,
                            (const void*)dfire_pairs_kernel<true>,
                            (const void*)dfire_pairs_worklist_kernel<false>,
                            (const void*)dfire_pairs_worklist_kernel<true>};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernels[which]);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernels[which],
                                                             kThreads, 0);
}
