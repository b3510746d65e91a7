// P1 with the canonical plan's product and layer-0 merge steps compiled
// in (K2S_PLANS[1]): one instantiation of qk::launch_p1 (chain_probe.cuh),
// in a file of its own so that it compiles in parallel with the others.

#include "chain_probe.cuh"

namespace qk {
QK_P1_INSTANCE(1);
}  // namespace qk
