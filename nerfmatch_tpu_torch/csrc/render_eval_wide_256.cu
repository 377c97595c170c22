// The render stage (kernels 1 and 1b, both trunks) at MLP width 256 and
// the wide encoding (2 * 3 * F in 97 .. 128): its instantiations
// (render_eval.cuh), in a translation unit of their own.
#include "render_eval.cuh"

NM_RENDER_EVAL_WIDE(256, false, bf16_256)
NM_RENDER_EVAL_WIDE(256, true, q8_256)
