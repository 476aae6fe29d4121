// Elec/vdw pair kernel with per-pose cull bits (K5) for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_elec_vdw_kernel (the v1
// kernel of elec_vdw_pairs_pallas; DNA and PYDOCK scoring).  For every
// pose: the raw sum over receptor x ligand atom pairs of
//   elec * scale + vdw,
//   elec = clip(qi qj / d2, elec_min, elec_max) * [d2 <= elec_cut2],
//   vdw  = min(sqrt(ei ej) (p6 p6 - 2 p6), vdw_max) * [d2 <= vdw_cut2],
//   p6   = ((ri + rj)^2 / d2)^3,
// plus per-atom interface flags at d2 <= iface2.  Every (receptor tile,
// ligand tile, pose) has its own cull bit and interface bit: a pose is
// scored on a tile only where its cull bit is 1, and flagged only where
// both are.  Every pair takes both terms.  The receptor is rigid (one copy
// for all poses) or per pose (receptor ANM).
//
// What bounds it on this card: the per-pair-pose arithmetic, about 40
// instructions with an IEEE reciprocal, not bytes: a block reads a few KB
// of coordinates and parameters for 16 x 32 x 128 pair-poses.  The per-atom
// parameters are a few KB for the whole complex, so unlike the step-form
// DFIRE kernel (K4) nothing forces a pair to stay on one SM for every pose.
// What the design does (the layout of elec_vdw_pairs.cu, K3):
//   * one thread block per (receptor tile, ligand tile, 16-pose chunk), 256
//     threads; each thread owns one ligand atom and keeps its coordinates
//     for all 16 poses in registers;
//   * the chunk's 16 cull bits and interface bits become two 16-bit masks;
//     a chunk with no active pose returns at once, and inactive poses of an
//     active chunk are skipped inside the pose loop;
//   * the pair parameters (qi qj, sqrt(ei ej), (ri + rj)^2) are formed
//     once per pair and reused for the 16 poses;
//   * the receptor tile sits in shared memory: 32 rows, or 16 poses x 32
//     rows (6 KB) for a per-pose receptor; a warp reads one row at a time,
//     a broadcast;
//   * interface hits are kept as 16-bit pose masks in registers and stored
//     after each row (receptor flags) and after the loop (ligand flags),
//     only for the poses hit;
//   * sums are deterministic: no float atomics.  Each block reduces its
//     per-pose sums in a fixed tree and writes them to a per-tile partial
//     row; a second kernel adds the tiles in order.
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
//
// Every operation is an explicit round-to-nearest intrinsic: no
// contraction into FMA, so each pair's term, and d2 with it, is bit-equal
// to the plain PyTorch version's and the cutoff masks and interface flags
// agree exactly; only the order of the sums differs.  The clamps are
// compare-and-select, not fminf/fmaxf, so a NaN from a coincident pair
// (d2 == 0: inf - inf in vdw) survives as in the reference, and the cutoff
// masks multiply as the TPU kernel's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sum_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 16;       // poses per chunk (POSE_BLOCK)
constexpr int kMaxRTile = 128;
constexpr int kWarps = kThreads / 32;

struct Consts {
  float elec_cut2, vdw_cut2, iface2, elec_min, elec_max, vdw_max, scale;
};

template <bool kPerPose>
__global__ void __launch_bounds__(kThreads)
elec_vdw_pairs_v1_kernel(const float* __restrict__ rec,   // (1 | gp, nr_pad, 3)
                         const float* __restrict__ lig,   // (gp, 3, nl_pad)
                         const float* __restrict__ qr, const float* __restrict__ ql,
                         const float* __restrict__ vcr, const float* __restrict__ vcl,
                         const float* __restrict__ vrr, const float* __restrict__ vrl,
                         const int32_t* __restrict__ act,        // (n_r, n_l, gp)
                         const int32_t* __restrict__ iface_act,  // (n_r, n_l, gp)
                         float* __restrict__ partial,            // (n_r * n_l, gp)
                         float* __restrict__ ifr,                // (gp, nr_pad) or null
                         float* __restrict__ ifl,                // (gp, nl_pad) or null
                         int nr_pad, int nl_pad, int gp, int r_tile, int l_tile,
                         Consts k) {
  __shared__ float s_rec[(kPerPose ? kPoses : 1) * kMaxRTile * 3];
  __shared__ float s_q[kMaxRTile], s_vc[kMaxRTile], s_vr[kMaxRTile];
  __shared__ float s_red[kWarps][kPoses];

  const int c = blockIdx.x;
  const int l = blockIdx.y;
  const int r = blockIdx.z;
  const int n_l = gridDim.y;
  const int tile = r * n_l + l;
  const int c0 = c * kPoses;
  const int tid = threadIdx.x;
  float* part = partial + (size_t)tile * gp + c0;

  // Bit p: pose c0 + p is scored (act) / flagged (iface) on this tile.
  unsigned act_mask = 0, iface_mask = 0;
  const int32_t* a = act + (size_t)tile * gp + c0;
  const int32_t* ia = iface_act + (size_t)tile * gp + c0;
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    act_mask |= (a[p] != 0 ? 1u : 0u) << p;
    if (ifr != nullptr) iface_mask |= (ia[p] != 0 ? 1u : 0u) << p;
  }
  iface_mask &= act_mask;
  if (act_mask == 0) {
    if (tid < kPoses) part[tid] = 0.0f;
    return;
  }

  const int r0 = r * r_tile;
  const int l0 = l * l_tile;
  if (kPerPose) {
    // s_rec[(p * r_tile + i) * 3 + x] = rec[c0 + p][r0 + i][x]
    for (int x = tid; x < kPoses * r_tile * 3; x += kThreads) {
      const int p = x / (r_tile * 3);
      const int rest = x - p * r_tile * 3;
      s_rec[x] = rec[((size_t)(c0 + p) * nr_pad + r0) * 3 + rest];
    }
  } else {
    for (int x = tid; x < r_tile * 3; x += kThreads) s_rec[x] = rec[(size_t)r0 * 3 + x];
  }
  for (int x = tid; x < r_tile; x += kThreads) {
    s_q[x] = qr[r0 + x];
    s_vc[x] = vcr[r0 + x];
    s_vr[x] = vrr[r0 + x];
  }
  __syncthreads();

  // Thread -> (ligand atom j, receptor rows i0, i0 + row_step, ...).
  const int j = tid % l_tile;
  const int i0 = tid / l_tile;
  const int row_step = kThreads / l_tile;

  float lx[kPoses], ly[kPoses], lz[kPoses], acc[kPoses];
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    const float* lp = lig + (size_t)(c0 + p) * 3 * nl_pad + l0 + j;
    lx[p] = lp[0];
    ly[p] = lp[nl_pad];
    lz[p] = lp[2 * nl_pad];
    acc[p] = 0.0f;
  }
  const float q_j = ql[l0 + j];
  const float vc_j = vcl[l0 + j];
  const float vr_j = vrl[l0 + j];

  unsigned lig_hits = 0;  // bit p: ligand atom j touches the interface in pose c0 + p
  for (int i = i0; i < r_tile; i += row_step) {
    const float qq = __fmul_rn(s_q[i], q_j);
    const float ve = __fsqrt_rn(__fmul_rn(s_vc[i], vc_j));
    const float vr = __fadd_rn(s_vr[i], vr_j);
    const float vr2 = __fmul_rn(vr, vr);
    unsigned rec_hits = 0;  // bit p: receptor atom r0 + i does, in pose c0 + p
#pragma unroll
    for (int p = 0; p < kPoses; ++p) {
      if (((act_mask >> p) & 1u) == 0) continue;
      const float* rp = s_rec + ((kPerPose ? p * r_tile : 0) + i) * 3;
      const float dx = __fsub_rn(lx[p], rp[0]);
      const float dy = __fsub_rn(ly[p], rp[1]);
      const float dz = __fsub_rn(lz[p], rp[2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float inv = __frcp_rn(d2);
      float e = __fmul_rn(qq, inv);
      e = e < k.elec_min ? k.elec_min : e;   // selects keep NaN
      e = e > k.elec_max ? k.elec_max : e;
      e = __fmul_rn(e, d2 <= k.elec_cut2 ? 1.0f : 0.0f);
      const float p2 = __fmul_rn(vr2, inv);
      const float p6 = __fmul_rn(__fmul_rn(p2, p2), p2);
      float v = __fmul_rn(ve, __fsub_rn(__fmul_rn(p6, p6), __fmul_rn(2.0f, p6)));
      v = v > k.vdw_max ? k.vdw_max : v;
      v = __fmul_rn(v, d2 <= k.vdw_cut2 ? 1.0f : 0.0f);
      acc[p] = __fadd_rn(acc[p], __fadd_rn(__fmul_rn(e, k.scale), v));
      rec_hits |= (d2 <= k.iface2 ? 1u : 0u) << p;
    }
    rec_hits &= iface_mask;
    if (rec_hits != 0) {
      lig_hits |= rec_hits;
      for (unsigned m = rec_hits; m != 0; m &= m - 1) {
        ifr[(size_t)(c0 + __ffs(m) - 1) * nr_pad + r0 + i] = 1.0f;
      }
    }
  }
  for (unsigned m = lig_hits; m != 0; m &= m - 1) {
    ifl[(size_t)(c0 + __ffs(m) - 1) * nl_pad + l0 + j] = 1.0f;
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

}  // namespace

extern "C" int elec_vdw_pairs_v1_launch(
    const void* rec, const void* lig, const void* qr, const void* ql,
    const void* vcr, const void* vcl, const void* vrr, const void* vrl,
    const void* act, const void* iface_act, void* partial, void* raw,
    void* ifr, void* ifl, int nr_pad, int nl_pad, int gp, int rec_poses,
    int r_tile, int l_tile, float elec_cut2, float vdw_cut2, float iface2,
    float elec_min, float elec_max, float vdw_max, float scale, void* stream) {
  if (r_tile <= 0 || r_tile > kMaxRTile || l_tile <= 0 ||
      l_tile > kThreads || kThreads % l_tile != 0 || nr_pad % r_tile != 0 ||
      nl_pad % l_tile != 0 || gp % kPoses != 0 ||
      (rec_poses != 1 && rec_poses != gp) || ((ifr == nullptr) != (ifl == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Consts k{elec_cut2, vdw_cut2, iface2, elec_min, elec_max, vdw_max, scale};
  const int n_r = nr_pad / r_tile;
  const int n_l = nl_pad / l_tile;
  const int n_chunks = gp / kPoses;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_chunks, n_l, n_r);
  const float* f_rec = static_cast<const float*>(rec);
  const float* f_lig = static_cast<const float*>(lig);
  const float* f_qr = static_cast<const float*>(qr);
  const float* f_ql = static_cast<const float*>(ql);
  const float* f_vcr = static_cast<const float*>(vcr);
  const float* f_vcl = static_cast<const float*>(vcl);
  const float* f_vrr = static_cast<const float*>(vrr);
  const float* f_vrl = static_cast<const float*>(vrl);
  const int32_t* i_act = static_cast<const int32_t*>(act);
  const int32_t* i_iface = static_cast<const int32_t*>(iface_act);
  float* f_part = static_cast<float*>(partial);
  float* f_ifr = static_cast<float*>(ifr);
  float* f_ifl = static_cast<float*>(ifl);
  if (rec_poses == 1) {
    elec_vdw_pairs_v1_kernel<false><<<grid, kThreads, 0, s>>>(
        f_rec, f_lig, f_qr, f_ql, f_vcr, f_vcl, f_vrr, f_vrl, i_act, i_iface,
        f_part, f_ifr, f_ifl, nr_pad, nl_pad, gp, r_tile, l_tile, k);
  } else {
    elec_vdw_pairs_v1_kernel<true><<<grid, kThreads, 0, s>>>(
        f_rec, f_lig, f_qr, f_ql, f_vcr, f_vcl, f_vrr, f_vrl, i_act, i_iface,
        f_part, f_ifr, f_ifl, nr_pad, nl_pad, gp, r_tile, l_tile, k);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), n_r * n_l, gp, s);
}
