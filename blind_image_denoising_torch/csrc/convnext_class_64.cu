// K1's class layouts (convnext_class.cuh) at K = 1, 3, 5: the widths 64 and 80.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(class_64_80, false, 64, 80)
