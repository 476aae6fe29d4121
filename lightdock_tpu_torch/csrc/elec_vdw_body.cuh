// The body shared by the elec/vdw pair kernels K3 (elec_vdw_pairs.cu, chunk
// bits) and K5 (elec_vdw_pairs_v1.cu, per-pose bits), for Hopper (sm_90a).
//
// One block scores one (receptor tile, ligand tile, 16-pose chunk): for
// every pose the sum over its atom pairs of
//   elec * scale + vdw,
//   elec = clip(qi qj / d2, elec_min, elec_max) * [d2 <= elec_cut2],
//   vdw  = min(sqrt(ei ej) (p6 p6 - 2 p6), vdw_max) * [d2 <= vdw_cut2],
//   p6   = ((ri + rj)^2 / d2)^3,
// plus per-atom interface flags at d2 <= iface2.  The kernel around it
// reads its bits and hands over a 16-bit mask of the poses to score and
// one of the poses to flag, and whether the chunk-tile takes the vdw term
// (K3's far chunk-tiles take the elec term alone and flag nothing).
//
// What bounds the body on this card: issuing the per-pair-pose
// instructions, not bytes (a block reads a few KB for 32 x 128 x 16
// pair-poses) and not the MUFU pipe (one reciprocal against about 30 other
// instructions).  What the design does about it:
//   * the pair parameters (qi qj, sqrt(ei ej), (ri + rj)^2: a sqrt and
//     four other operations) are formed once per pair and reused for the
//     8 poses a thread holds: two threads share a ligand atom, each keeping
//     its coordinates and sums for 8 of the chunk's 16 poses in registers,
//     and each runs every receptor row of the tile.  Lanes over poses (K1's
//     layout, which coalesces K1's table loads) would form them again in
//     every lane; K3 and K5 load no table;
//   * 8 poses a thread at 4 blocks an SM: 64 registers, no spills and 32
//     resident warps to hide the MUFU and shared-load latency.  16 poses
//     a thread (2 blocks, 108-128 registers, 16 warps) spread the pair
//     parameters over twice the poses, a few per cent fewer instructions,
//     but ran slower at 6,400 poses, where the body sets the call's time,
//     and only a little faster at 200, where the wrapper's host work sets
//     it (PERF.md);
//   * the reciprocal is the hardware's, rcp.approx.ftz.f32: one MUFU
//     instruction where the IEEE __frcp_rn is a MUFU op, Newton steps and
//     a special-case branch, with which the body took about half as long
//     again (PERF.md).  The PTX ISA gives its maximum error as 2^-23
//     over 1.0-2.0, the mantissa's range, so a term moves by an ulp or two
//     and the sums stay well inside the DNA/PYDOCK tolerance, 5e-5
//     (tests/test_torch_elec_vdw_rcp.py models every 1/d2 moved by 2 ulps
//     against the JAX kernels).  At d2 == 0 it is still +inf, so a
//     coincident pair still gives NaN through inf - inf;
//   * d2 stays the exact sequence ((dx*dx) + (dy*dy)) + (dz*dz) of
//     round-to-nearest intrinsics, with no contraction into FMA, so d2 is
//     bit-equal to the plain PyTorch version's and every cutoff mask and
//     interface flag agrees exactly;
//   * each NaN-keeping clamp is one min.NaN.f32 / max.NaN.f32 (sm_80+),
//     not a compare and a select; the cutoff masks stay multiplies, as in
//     the TPU kernel, so NaN * 0 stays NaN;
//   * the receptor tile (at most 32 rows) sits in shared memory as float4s:
//     a row's (q, ei, ri) and, rigid, its (x, y, z), two broadcast loads a
//     row; per pose, (x, y, z) at [row][pose], one broadcast vector load a
//     pair-pose instead of three scalar ones;
//   * interface hits stay in registers: a mask of the thread's poses a
//     row, stored after the row for the receptor atom, OR-ed into the
//     ligand atom's mask, which is stored after the loop, only for the
//     poses hit;
//   * the vdw term, the interface work and K5's per-pose skip are template
//     arguments chosen once a block, so the pose loop has no branch
//     (K5 tests a pose's bit only in a chunk where some pose is culled);
//   * sums are deterministic: no float atomics.  Each block reduces its
//     per-pose sums in a fixed tree and writes them to a per-tile partial
//     row; a second kernel adds the rows in order (sum_rows.cuh).
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEvThreads = 256;
constexpr int kEvPoses = 16;         // poses a chunk (POSE_BLOCK)
constexpr int kEvThreadPoses = 8;    // poses a thread holds
constexpr int kEvPoseGroups = kEvPoses / kEvThreadPoses;
constexpr int kEvMinBlocks = 4;      // 4 x 256 threads an SM: at most 64 registers
constexpr int kEvMaxRTile = 32;      // receptor rows a tile
constexpr int kEvWarps = kEvThreads / 32;

struct EvInputs {
  const float* rec;   // (1 | gp, nr_pad, 3)
  const float* lig;   // (gp, 3, nl_pad)
  const float* qr;    // (nr_pad,) charges, vdw energies, vdw radii
  const float* ql;    // (nl_pad,)
  const float* vcr;
  const float* vcl;
  const float* vrr;
  const float* vrl;
  float* ifr;         // (gp, nr_pad) or null
  float* ifl;         // (gp, nl_pad) or null
  int nr_pad, nl_pad, gp, r_tile, l_tile, n_l, n_chunks;
  float elec_cut2, vdw_cut2, iface2, elec_min, elec_max, vdw_max, scale;
};

// Checks the shapes and fills in; 0 or a CUDA error code.  Receptor tiles
// of at most 32 rows, ligand tiles of 32, 64 or 128 atoms (whole warps, at
// least two threads an atom), poses in whole chunks.
inline int ev_prepare(const void* rec, const void* lig, const void* qr, const void* ql,
                      const void* vcr, const void* vcl, const void* vrr, const void* vrl,
                      void* ifr, void* ifl, int nr_pad, int nl_pad, int gp, int rec_poses,
                      int r_tile, int l_tile, float elec_cut2, float vdw_cut2, float iface2,
                      float elec_min, float elec_max, float vdw_max, float scale,
                      EvInputs* in) {
  if (r_tile <= 0 || r_tile > kEvMaxRTile || l_tile <= 0 || l_tile % 32 != 0 ||
      kEvThreads % (l_tile * kEvPoseGroups) != 0 || kEvThreads / l_tile < 2 ||
      nr_pad % r_tile != 0 || nl_pad % l_tile != 0 || gp % kEvPoses != 0 ||
      (rec_poses != 1 && rec_poses != gp) || ((ifr == nullptr) != (ifl == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  *in = EvInputs{static_cast<const float*>(rec), static_cast<const float*>(lig),
                 static_cast<const float*>(qr),  static_cast<const float*>(ql),
                 static_cast<const float*>(vcr), static_cast<const float*>(vcl),
                 static_cast<const float*>(vrr), static_cast<const float*>(vrl),
                 static_cast<float*>(ifr), static_cast<float*>(ifl), nr_pad, nl_pad, gp,
                 r_tile, l_tile, nl_pad / l_tile, gp / kEvPoses, elec_cut2, vdw_cut2,
                 iface2, elec_min, elec_max, vdw_max, scale};
  return 0;
}

__device__ __forceinline__ float ev_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// min / max that return NaN when either operand is NaN, as torch.clamp does.
__device__ __forceinline__ float ev_min_nan(float a, float b) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

__device__ __forceinline__ float ev_max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// The thread's receptor rows i0, i0 + row_step, ... for its poses: adds each
// pair's term to acc[p] (kVdw false: the elec term alone).  kIface: flags
// the hits of the poses in `iface`.  kMasked: skips the poses not in `act`.
template <bool kPerPose, bool kVdw, bool kIface, bool kMasked>
__device__ __forceinline__ void ev_rows(const EvInputs& in, const float4* s_rec,
                                        const float4* s_par, int i0, int row_step,
                                        int pbase, const float (&lx)[kEvThreadPoses],
                                        const float (&ly)[kEvThreadPoses],
                                        const float (&lz)[kEvThreadPoses], float q_j,
                                        float vc_j, float vr_j, unsigned act,
                                        unsigned iface, size_t pose0, int r0, int lj,
                                        float (&acc)[kEvThreadPoses]) {
  unsigned lig_hits = 0u;  // bit p: the ligand atom touches the interface in pose p
  for (int i = i0; i < in.r_tile; i += row_step) {
    const float4 par = s_par[i];  // q, ei, ri of receptor row i
    const float qq = __fmul_rn(par.x, q_j);
    float ve = 0.0f, vr2 = 0.0f;
    if (kVdw) {
      ve = __fsqrt_rn(__fmul_rn(par.y, vc_j));
      const float vr = __fadd_rn(par.z, vr_j);
      vr2 = __fmul_rn(vr, vr);
    }
    float4 rr = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!kPerPose) rr = s_rec[i];
    unsigned rec_hits = 0u;  // bit p: receptor row i touches the interface in pose p
#pragma unroll
    for (int p = 0; p < kEvThreadPoses; ++p) {
      if (kMasked && ((act >> p) & 1u) == 0u) continue;
      const float4 rp = kPerPose ? s_rec[i * kEvPoses + pbase + p] : rr;
      const float dx = __fsub_rn(lx[p], rp.x);
      const float dy = __fsub_rn(ly[p], rp.y);
      const float dz = __fsub_rn(lz[p], rp.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float inv = ev_rcp(d2);
      const float e = ev_min_nan(ev_max_nan(__fmul_rn(qq, inv), in.elec_min), in.elec_max);
      float term = __fmul_rn(__fmul_rn(e, d2 <= in.elec_cut2 ? 1.0f : 0.0f), in.scale);
      if (kVdw) {
        const float p2 = __fmul_rn(vr2, inv);
        const float p6 = __fmul_rn(__fmul_rn(p2, p2), p2);
        const float v = __fmul_rn(ve, __fsub_rn(__fmul_rn(p6, p6), __fmul_rn(2.0f, p6)));
        term = __fadd_rn(term, __fmul_rn(ev_min_nan(v, in.vdw_max),
                                         d2 <= in.vdw_cut2 ? 1.0f : 0.0f));
      }
      acc[p] = __fadd_rn(acc[p], term);
      if (kIface) rec_hits |= (d2 <= in.iface2 ? 1u : 0u) << p;
    }
    if (kIface) {
      rec_hits &= iface;
      if (rec_hits != 0u) {
        lig_hits |= rec_hits;
        for (unsigned m = rec_hits; m != 0u; m &= m - 1u) {
          in.ifr[(pose0 + __ffs(m) - 1) * in.nr_pad + r0 + i] = 1.0f;
        }
      }
    }
  }
  if (kIface) {
    for (unsigned m = lig_hits; m != 0u; m &= m - 1u) {
      in.ifl[(pose0 + __ffs(m) - 1) * in.nl_pad + lj] = 1.0f;
    }
  }
}

// One block: receptor tile r, ligand tile l, pose chunk c.  act_mask bit p:
// pose 16c + p is scored; iface_mask (within act_mask): its hits are
// flagged; vdw false: the elec term alone.  kPoseBits: the masks are K5's
// per-pose bits (some poses of a chunk may be culled; vdw is always true);
// else K3's chunk bits (each mask 0 or every pose).  Writes the chunk's 16
// per-pose sums to part[0..15].
template <bool kPerPose, bool kPoseBits>
__device__ __forceinline__ void ev_block(const EvInputs& in, int r, int l, int c,
                                         unsigned act_mask, unsigned iface_mask, bool vdw,
                                         float* part) {
  __shared__ float4 s_rec[kPerPose ? kEvMaxRTile * kEvPoses : kEvMaxRTile];  // x, y, z, -
  __shared__ float4 s_par[kEvMaxRTile];                                      // q, ei, ri, -
  __shared__ float s_red[kEvWarps][kEvThreadPoses];

  const int tid = threadIdx.x;
  const int c0 = c * kEvPoses;
  if (act_mask == 0u) {
    if (tid < kEvPoses) part[tid] = 0.0f;
    return;
  }
  const int r_tile = in.r_tile;
  const int r0 = r * r_tile;
  const int l0 = l * in.l_tile;
  if (kPerPose) {
    // Read in the source order; s_rec[i * 16 + p] = rec[c0 + p][r0 + i].
    float* s = reinterpret_cast<float*>(s_rec);
    for (int e = tid; e < kEvPoses * r_tile * 3; e += kEvThreads) {
      const int p = e / (r_tile * 3);
      const int rest = e - p * r_tile * 3;
      const int i = rest / 3;
      s[(i * kEvPoses + p) * 4 + (rest - i * 3)] =
          in.rec[((size_t)(c0 + p) * in.nr_pad + r0) * 3 + rest];
    }
  } else if (tid < r_tile) {
    const float* q = in.rec + (size_t)(r0 + tid) * 3;
    s_rec[tid] = make_float4(q[0], q[1], q[2], 0.0f);
  }
  if (tid < r_tile) {
    s_par[tid] = make_float4(in.qr[r0 + tid], in.vcr[r0 + tid], in.vrr[r0 + tid], 0.0f);
  }
  __syncthreads();

  // Thread -> (ligand atom j, pose group, receptor rows i0, i0 + row_step,
  // ...); l_tile is a multiple of 32, so a warp's lanes share a pose group
  // and read the same receptor entry.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = tid % in.l_tile;
  const int grp = tid / in.l_tile;
  const int pbase = (grp % kEvPoseGroups) * kEvThreadPoses;
  const int i0 = grp / kEvPoseGroups;
  const int row_step = kEvThreads / in.l_tile / kEvPoseGroups;
  const size_t pose0 = (size_t)(c0 + pbase);
  constexpr unsigned kThreadMask = (1u << kEvThreadPoses) - 1u;
  const unsigned act = (act_mask >> pbase) & kThreadMask;
  const unsigned iface = (iface_mask >> pbase) & kThreadMask;

  float lx[kEvThreadPoses], ly[kEvThreadPoses], lz[kEvThreadPoses], acc[kEvThreadPoses];
#pragma unroll
  for (int p = 0; p < kEvThreadPoses; ++p) {
    const float* lp = in.lig + (pose0 + p) * 3 * in.nl_pad + l0 + j;
    lx[p] = __ldg(lp);
    ly[p] = __ldg(lp + in.nl_pad);
    lz[p] = __ldg(lp + 2 * in.nl_pad);
    acc[p] = 0.0f;
  }
  const float q_j = __ldg(in.ql + l0 + j);
  const float vc_j = __ldg(in.vcl + l0 + j);
  const float vr_j = __ldg(in.vrl + l0 + j);

  // Block-uniform choices: no branch inside the pose loop.
  const bool masked = kPoseBits && act_mask != (1u << kEvPoses) - 1u;
  const bool flag = in.ifr != nullptr && iface_mask != 0u;
#define EV_ROWS(vdw_, iface_, masked_)                                                 \
  ev_rows<kPerPose, vdw_, iface_, masked_>(in, s_rec, s_par, i0, row_step, pbase, lx, \
                                           ly, lz, q_j, vc_j, vr_j, act, iface, pose0, \
                                           r0, l0 + j, acc)
  if (!kPoseBits && !vdw) EV_ROWS(false, false, false);
  else if (masked && flag) EV_ROWS(true, true, true);
  else if (masked) EV_ROWS(true, false, true);
  else if (flag) EV_ROWS(true, true, false);
  else EV_ROWS(true, false, false);
#undef EV_ROWS

  // Fixed-order block reduction: each pose over a warp's lanes, then over
  // the warps of its pose group in order.
#pragma unroll
  for (int p = 0; p < kEvThreadPoses; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) s_red[warp][p] = v;
  }
  __syncthreads();
  if (tid < kEvPoses) {
    const int g = tid / kEvThreadPoses;
    float s = 0.0f;
    for (int w = 0; w < kEvWarps; ++w) {
      if ((w * 32 / in.l_tile) % kEvPoseGroups == g) {
        s = __fadd_rn(s, s_red[w][tid % kEvThreadPoses]);
      }
    }
    part[tid] = s;
  }
}

// Registers, local (stack and spill) bytes a thread, static shared memory
// a block and blocks of kEvThreads an SM of one kernel; 0 or a CUDA error
// code.
inline int ev_occupancy(const void* kernel, int* blocks_per_sm, int* regs, int* local_bytes,
                        int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kEvThreads, 0);
}

}  // namespace
