// TPU kernel #12, the C entry: tools/attn_variants.py:flash_variant
// (:137) -> _onepass_kernel (:77) and _innerloop_kernel (:110), attention on
// pre-scaled (BH, N, D) q, k and v, D = 64, whose keys the JAX wrapper
// zero-pads to a multiple of 128; the kernels read rows at or past N as zeros
// instead of a padded copy. Modes: mask_exp and mask_exp2 (an iota mask,
// then exp or exp2), padfix and chunk (MODE_PADFIX: the zero pad keys count
// in the max and pads * 2^-m is taken off l, including its failure when every
// real logit is far below 0), and the ablations nosm, maxonly (two passes:
// the final row max over real and pad keys first) and exponly. Every
// bfloat16 launch runs the wgmma/TMA kernel of flash_variant_sm90.cu, one
// instantiation per mode and CTA height; a layout its tensor maps cannot
// read is refused. float32 runs fv_f32<1, MODE> (flash_variants.cuh). A
// measurement tool: no serving route reaches it.

#include "flash_variants.cuh"

// flash_variant_sm90.cu: every bfloat16 launch
cudaError_t flash_variant_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                               const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int kend,
                               int mode, float qk_scale_log2, cudaStream_t stream);

namespace {

// flash_variant_sm90.cu's FvMode of a #12 Mode, and its scale into the exp2
// domain: mask_exp's natural exp is exp2 of the logit times log2(e).
constexpr int FV_MASK = 0, FV_PADFIX = 1, FV_NOSM = 2, FV_EXPONLY = 3, FV_MAXONLY = 4;

cudaError_t launch_sm90(const VArgs& a, int mode, dim3 grid, cudaStream_t s) {
    int fv_mode;
    float scale_log2 = a.qk_scale;
    switch (mode) {
        case MODE_MASK_EXP: fv_mode = FV_MASK, scale_log2 = a.qk_scale * LOG2E; break;
        case MODE_MASK_EXP2: fv_mode = FV_MASK; break;
        case MODE_PADFIX: fv_mode = FV_PADFIX; break;
        case MODE_NOSM: fv_mode = FV_NOSM; break;
        case MODE_EXPONLY: fv_mode = FV_EXPONLY; break;
        case MODE_MAXONLY: fv_mode = FV_MAXONLY; break;
        default: return cudaErrorInvalidValue;
    }
    const Strides st = strides_of(a);
    return flash_variant_sm90(a.q, st.q, a.k, st.k, a.v, st.v, a.o, st.o, grid.z, a.n, grid.y, a.kend, fv_mode, scale_log2, s);
}

cudaError_t launch_f32_mode(const VArgs& a, int mode, dim3 grid, cudaStream_t s) {
    switch (mode) {
        case MODE_MASK_EXP: return launch_f32<1, MODE_MASK_EXP>(a, grid, s);
        case MODE_MASK_EXP2: return launch_f32<1, MODE_MASK_EXP2>(a, grid, s);
        case MODE_PADFIX: return launch_f32<1, MODE_PADFIX>(a, grid, s);
        case MODE_NOSM: return launch_f32<1, MODE_NOSM>(a, grid, s);
        case MODE_MAXONLY: return launch_f32<1, MODE_MAXONLY>(a, grid, s);
        case MODE_EXPONLY: return launch_f32<1, MODE_EXPONLY>(a, grid, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is one of the #12 modes,
// SLOT_QP 1; SLOT_KEYS may differ from SLOT_N (pad keys, or a chunk cut).
// Returns the cudaError_t of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int mdpt_flash_variant(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream, true,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (qp != 1 || pipelined) return cudaErrorInvalidValue;
                             return dtype == 1 ? launch_sm90(a, mode, grid, s) : launch_f32_mode(a, mode, grid, s);
                         });
}
