// K1's class layouts (convnext_class.cuh) at K = 7: the widths 16, 32, 48 and 64.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(k7_class_16_64, true, 16, 32, 48, 64)
