// Elec/vdw pair kernel with per-pose cull bits (K5) for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_elec_vdw_kernel (the v1
// kernel of elec_vdw_pairs_pallas; DNA and PYDOCK scoring): per pose, the
// raw elec + vdw sum and the interface flags of elec_vdw_body.cuh, whose
// note says what bounds the body and what its design does.  Every
// (receptor tile, ligand tile, pose) has its own cull and interface bit: a
// pose is scored on a tile only where its cull bit is 1, flagged only where
// both are, and every pair takes both terms.  One block per (receptor
// tile, ligand tile, 16-pose chunk), the chunk's bits as the body's 16-bit
// masks, then the second pass (sum_rows.cuh, rows in tile order).

#include "elec_vdw_body.cuh"   // cuda_runtime.h, stdint.h
#include "sum_rows.cuh"

namespace {

template <bool kPerPose>
__global__ void __launch_bounds__(kEvThreads, kEvMinBlocks)
elec_vdw_pairs_v1_kernel(EvInputs in,
                         const int32_t* __restrict__ act,        // (n_r, n_l, gp)
                         const int32_t* __restrict__ iface_act,  // (n_r, n_l, gp)
                         float* __restrict__ partial) {          // (n_r * n_l, gp)
  const int c = blockIdx.x, l = blockIdx.y, r = blockIdx.z;
  const int tile = r * in.n_l + l;
  const size_t off = (size_t)tile * in.gp + c * kEvPoses;
  // Bit p: pose 16c + p is scored (act) / flagged (iface) on this tile.
  unsigned act_mask = 0u, iface_mask = 0u;
#pragma unroll
  for (int p = 0; p < kEvPoses; ++p) {
    act_mask |= (act[off + p] != 0 ? 1u : 0u) << p;
    if (in.ifr != nullptr) iface_mask |= (iface_act[off + p] != 0 ? 1u : 0u) << p;
  }
  ev_block<kPerPose, true>(in, r, l, c, act_mask, iface_mask & act_mask, true, partial + off);
}

}  // namespace

extern "C" int elec_vdw_pairs_v1_launch(
    const void* rec, const void* lig, const void* qr, const void* ql,
    const void* vcr, const void* vcl, const void* vrr, const void* vrl,
    const void* act, const void* iface_act, void* partial, void* raw,
    void* ifr, void* ifl, int nr_pad, int nl_pad, int gp, int rec_poses,
    int r_tile, int l_tile, float elec_cut2, float vdw_cut2, float iface2,
    float elec_min, float elec_max, float vdw_max, float scale, void* stream) {
  EvInputs in;
  const int err = ev_prepare(rec, lig, qr, ql, vcr, vcl, vrr, vrl, ifr, ifl, nr_pad, nl_pad,
                             gp, rec_poses, r_tile, l_tile, elec_cut2, vdw_cut2, iface2,
                             elec_min, elec_max, vdw_max, scale, &in);
  if (err != 0) return err;
  const int n_r = nr_pad / r_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(in.n_chunks, in.n_l, n_r);
  const int32_t* i_act = static_cast<const int32_t*>(act);
  const int32_t* i_iface = static_cast<const int32_t*>(iface_act);
  float* f_part = static_cast<float*>(partial);
  if (rec_poses == 1) {
    elec_vdw_pairs_v1_kernel<false><<<grid, kEvThreads, 0, s>>>(in, i_act, i_iface, f_part);
  } else {
    elec_vdw_pairs_v1_kernel<true><<<grid, kEvThreads, 0, s>>>(in, i_act, i_iface, f_part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), n_r * in.n_l, gp, s);
}

// Occupancy of K5 for the smoke run's report, as elec_vdw_pairs_occupancy
// reports K3's.  which: 0 rigid, 1 per-pose receptor.
extern "C" int elec_vdw_pairs_v1_occupancy(int which, int* blocks_per_sm, int* regs,
                                           int* local_bytes, int* smem_bytes) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const void* kernel = which == 0 ? (const void*)elec_vdw_pairs_v1_kernel<false>
                                  : (const void*)elec_vdw_pairs_v1_kernel<true>;
  return ev_occupancy(kernel, blocks_per_sm, regs, local_bytes, smem_bytes);
}
