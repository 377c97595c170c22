// The NeRF train-render forward (kernel 5) and trunk backward (kernel 6's
// launch 1) at MLP width 512: their instantiations (render_train_512.cuh),
// in a translation unit of their own.
#include "render_train_512.cuh"

NM_RENDER_TRAIN_512
