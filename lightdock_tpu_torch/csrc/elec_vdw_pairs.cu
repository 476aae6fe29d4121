// Elec/vdw pair kernel (K3) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_elec_vdw_kernel_v2 (DNA and
// PYDOCK scoring): per pose, the raw elec + vdw sum and the interface flags
// of elec_vdw_body.cuh, whose note says what bounds the body and what its
// design does.  Bits are per (receptor tile, ligand tile, 16-pose chunk): a
// triple whose cull bit is 0 is skipped; one whose near bit is 0 takes the
// elec term alone and flags nothing; a near triple flags the hits of all 16
// poses when any pose's interface bit is set, as the TPU kernel does.  One
// block a triple, then the second pass (sum_rows.cuh, rows in tile order).

#include "elec_vdw_body.cuh"   // cuda_runtime.h, stdint.h
#include "sum_rows.cuh"

namespace {

template <bool kPerPose>
__global__ void __launch_bounds__(kEvThreads, kEvMinBlocks)
elec_vdw_pairs_kernel(EvInputs in,
                      const int32_t* __restrict__ act,        // (n_r, n_l, n_chunks)
                      const int32_t* __restrict__ iface_act,  // (n_r, n_l, gp)
                      const int32_t* __restrict__ near,       // (n_r, n_l, n_chunks) or null
                      float* __restrict__ partial) {          // (n_r * n_l, gp)
  const int c = blockIdx.x, l = blockIdx.y, r = blockIdx.z;
  const int tile = r * in.n_l + l;
  const bool active = act[(size_t)tile * in.n_chunks + c] != 0;
  const bool is_near = near == nullptr || near[(size_t)tile * in.n_chunks + c] != 0;
  bool any_iface = false;
  if (active && is_near && in.ifr != nullptr) {
    const int32_t* ia = iface_act + (size_t)tile * in.gp + c * kEvPoses;
    for (int p = 0; p < kEvPoses; ++p) any_iface |= ia[p] != 0;
  }
  constexpr unsigned kAll = (1u << kEvPoses) - 1u;
  ev_block<kPerPose, false>(in, r, l, c, active ? kAll : 0u, any_iface ? kAll : 0u, is_near,
                            partial + (size_t)tile * in.gp + c * kEvPoses);
}

}  // namespace

extern "C" int elec_vdw_pairs_launch(
    const void* rec, const void* lig, const void* qr, const void* ql,
    const void* vcr, const void* vcl, const void* vrr, const void* vrl,
    const void* act, const void* iface_act, const void* near, void* partial,
    void* raw, void* ifr, void* ifl, int nr_pad, int nl_pad, int gp,
    int rec_poses, int r_tile, int l_tile, float elec_cut2, float vdw_cut2,
    float iface2, float elec_min, float elec_max, float vdw_max, float scale,
    void* stream) {
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
  const int32_t* i_near = static_cast<const int32_t*>(near);
  float* f_part = static_cast<float*>(partial);
  if (rec_poses == 1) {
    elec_vdw_pairs_kernel<false><<<grid, kEvThreads, 0, s>>>(in, i_act, i_iface, i_near, f_part);
  } else {
    elec_vdw_pairs_kernel<true><<<grid, kEvThreads, 0, s>>>(in, i_act, i_iface, i_near, f_part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), n_r * in.n_l, gp, s);
}

// Occupancy of K3 for the smoke run's report.  which: 0 rigid, 1 per-pose
// receptor.  Fills the blocks of 256 threads an SM can hold, the registers
// and local (stack and spill) bytes a thread and the static shared memory
// a block; 0 or a CUDA error code.
extern "C" int elec_vdw_pairs_occupancy(int which, int* blocks_per_sm, int* regs,
                                        int* local_bytes, int* smem_bytes) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const void* kernel = which == 0 ? (const void*)elec_vdw_pairs_kernel<false>
                                  : (const void*)elec_vdw_pairs_kernel<true>;
  return ev_occupancy(kernel, blocks_per_sm, regs, local_bytes, smem_bytes);
}
