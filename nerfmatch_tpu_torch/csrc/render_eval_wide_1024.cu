// The render stage (kernels 1 and 1b, both trunks) at MLP width 1024 and
// the wide encoding (2 * 3 * F in 97 .. 128): its instantiations
// (render_eval_512.cuh), in a translation unit of their own.
#include "render_eval_512.cuh"

NM_RENDER_EVAL_TILE_WIDE(1024, false, bf16_1024)
NM_RENDER_EVAL_TILE_WIDE(1024, true, q8_1024)
