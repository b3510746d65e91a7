// K3's warp-per-row kernel with its modes read at run time: the
// instantiations of qk::launch_warp (qreduce.cuh) for every lane type, S
// and stack depth, in a file of their own so that they compile in
// parallel with the others.

#include "qreduce.cuh"

namespace qk {
QK_K3_WARP_ALL();
}  // namespace qk
