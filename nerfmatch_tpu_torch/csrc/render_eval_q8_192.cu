// The render stage (kernel 1b, the int8 trunk) at MLP width 192: its
// instantiations (render_eval.cuh), in a translation unit of their own.
#include "render_eval.cuh"

NM_RENDER_EVAL_WIDTH(192, true, q8_192)
