// The NeRF train-render forward (kernel 5) at MLP width 512 and the wide
// encoding (2 * 3 * F in 97 .. 128): its instantiations
// (render_train_512.cuh), in a translation unit of their own.
#include "render_train_512.cuh"

NM_RENDER_TRAIN_WIDE_512
