// The render stage (kernels 1 and 1b, both trunks) at MLP width 512 and
// the wide encoding (2 * 3 * F in 97 .. 128): its instantiations
// (render_eval_512.cuh), in a translation unit of their own.
#include "render_eval_512.cuh"

NM_RENDER_EVAL_TILE_WIDE(512, false, bf16_512)
NM_RENDER_EVAL_TILE_WIDE(512, true, q8_512)
