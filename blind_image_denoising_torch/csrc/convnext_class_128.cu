// K1's class layouts (convnext_class.cuh) at K = 1, 3, 5: the width 128.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(class_128, false, 128)
