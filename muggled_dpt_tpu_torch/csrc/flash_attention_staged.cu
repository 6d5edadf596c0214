// TPU kernel #11 for Hopper (sm_90a): experiments/flash_attention_staged.py:
// flash_attention_fused_qkv_staged -> _staged_qkv_kernel (:74), #1 on the
// head-major (B, N, 3C) qkv slab, unbiased, D = 64, as a two-pass schedule
// with no online rescaling: pass 1 streams K and keeps only the row max,
// key panel by key panel (the panels of _panel_bounds, run in sequence in one
// CTA, each reducing its own max before the row takes their maximum); pass 2
// recomputes QK^T, streams K and V and takes exp2(s - m), PV and the row sum.
// The -1e30 pad mask applies before the max. The kernel template, its
// numerics and its bound are in flash_variants.cuh (MODE_STAGED).

#include "flash_variants.cuh"

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is MODE_STAGED, SLOT_QP 1,
// SLOT_PANEL the panel width in keys. Returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int mdpt_flash_attention_staged(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (mode != MODE_STAGED || qp != 1 || pipelined) return cudaErrorInvalidValue;
                             return launch_variant<1, false, MODE_STAGED>(a, dtype, grid, s);
                         });
}
