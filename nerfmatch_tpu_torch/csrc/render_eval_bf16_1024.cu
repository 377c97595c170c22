// The render stage (kernel 1, the bf16 trunk) at MLP width 1024: its
// instantiations (render_eval_512.cuh), in a translation unit of their own.
#include "render_eval_512.cuh"

NM_RENDER_EVAL_TILE(1024, false, bf16_1024)
