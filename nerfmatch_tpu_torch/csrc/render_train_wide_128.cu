// The NeRF train-render forward (kernel 5) at MLP width 128 and the wide
// encoding (2 * 3 * F in 97 .. 128): its instantiations
// (render_train.cuh), in a translation unit of their own.
#include "render_train.cuh"

NM_RENDER_TRAIN_WIDE(128)
