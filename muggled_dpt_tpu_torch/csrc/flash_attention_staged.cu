// TPU kernel #11, the C entry: experiments/flash_attention_staged.py:
// flash_attention_fused_qkv_staged (:144) -> _staged_qkv_kernel (:74), #1
// on the head-major (B, N, 3C) qkv slab, unbiased, D = 64, as a two-pass
// schedule with no online rescaling: pass 1 streams K and keeps only the
// row max, key panel by key panel (the panels of _panel_bounds, run in
// sequence in one CTA, each reducing its own max before the row takes their
// maximum); pass 2 recomputes QK^T, streams K and V and takes exp2(s - m),
// PV and the row sum. Keys past N are masked before the max. Every bfloat16
// launch runs the wgmma/TMA kernel of flash_staged_sm90.cu; a layout its
// tensor maps cannot read is refused. float32 runs fv_f32<1, MODE_STAGED>
// (flash_variants.cuh).

#include "flash_variants.cuh"

// flash_staged_sm90.cu: every bfloat16 launch
cudaError_t flash_staged_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                              const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int panel,
                              float qk_scale_log2, cudaStream_t stream);

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is MODE_STAGED, SLOT_QP 1,
// SLOT_PANEL the panel width in keys (bf16: a multiple of 128). Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int mdpt_flash_attention_staged(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream, false,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (mode != MODE_STAGED || qp != 1 || pipelined) return cudaErrorInvalidValue;
                             if (dtype == 1) {
                                 const Strides st = strides_of(a);
                                 return flash_staged_sm90(a.q, st.q, a.k, st.k, a.v, st.v, a.o, st.o, grid.z, a.n, grid.y,
                                                          a.panel, a.qk_scale, s);
                             }
                             return launch_f32<1, MODE_STAGED>(a, grid, s);
                         });
}
