// K1's class layouts (convnext_class.cuh) at K = 7: the widths 112 and 128.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(k7_class_112_128, true, 112, 128)
