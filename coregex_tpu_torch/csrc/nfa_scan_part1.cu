// The bitset-NFA scan's kernels without looks at NW = 1-4 (csrc/nfa_scan.cu), in a
// translation unit of their own so that nvcc builds the scan's kernels
// side by side.
#define CGX_NFA_PART 1
#include "nfa_scan.cu"
