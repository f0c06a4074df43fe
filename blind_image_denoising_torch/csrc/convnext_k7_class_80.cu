// K1's class layouts (convnext_class.cuh) at K = 7: the widths 80 and 96.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(k7_class_80_96, true, 80, 96)
