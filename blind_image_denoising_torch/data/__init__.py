"""Host-side input pipeline (counterpart of
``blind_image_denoising_tpu/data``): file discovery, decode, random
crops, round-robin dataset merging, threaded decode and the host →
device prefetch. The host yields clean [B, H, W, C] batches in [0, 255];
flips and noise run on the device inside the train step."""

from .dataset import DatasetResults, dataset_builder, random_crops
from .file_operations import (image_filenames, image_filenames_generator,
                              load_image, merge_iterators)
