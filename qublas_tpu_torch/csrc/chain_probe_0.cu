// P1 with every step read at run time (K2S_PLANS[0]): one instantiation
// of qk::launch_p1 (chain_probe.cuh), in a file of its own so that it
// compiles in parallel with the others.

#include "chain_probe.cuh"

namespace qk {
QK_P1_INSTANCE(0);
}  // namespace qk
