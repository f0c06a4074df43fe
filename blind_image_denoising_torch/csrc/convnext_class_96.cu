// K1's class layouts (convnext_class.cuh) at K = 1, 3, 5: the widths 96 and 112.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(class_96_112, false, 96, 112)
