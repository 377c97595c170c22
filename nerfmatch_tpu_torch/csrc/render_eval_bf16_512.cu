// The render stage (kernel 1, the bf16 trunk) at MLP width 512: its
// instantiations (render_eval_512.cuh), in a translation unit of their own.
#include "render_eval_512.cuh"

NM_RENDER_EVAL_TILE(512, false, bf16_512)
