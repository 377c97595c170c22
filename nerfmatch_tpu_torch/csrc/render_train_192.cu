// The NeRF train-render forward (kernel 5) and trunk backward (kernel 6's
// launch 1) at MLP width 192: their instantiations (render_train.cuh), in a
// translation unit of their own.
#include "render_train.cuh"

NM_RENDER_TRAIN_WIDTH(192)
