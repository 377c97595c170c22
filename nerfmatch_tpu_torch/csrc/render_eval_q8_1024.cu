// The render stage (kernel 1b, the int8 trunk) at MLP width 1024: its
// instantiations (render_eval_512.cuh), in a translation unit of their own.
#include "render_eval_512.cuh"

NM_RENDER_EVAL_TILE(1024, true, q8_1024)
