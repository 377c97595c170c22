// The render stage (kernel 1, the bf16 trunk) at MLP width 64: its
// instantiations (render_eval.cuh), in a translation unit of their own.
#include "render_eval.cuh"

NM_RENDER_EVAL_WIDTH(64, false, bf16_64)
