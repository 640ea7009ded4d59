"""Normalization constants (torchvision's ImageNet statistics).

HHA is encoded into an image-like [0, 255] range and normalized with the
RGB constants, as in the reference.
"""

import numpy as np

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
HHA_MEAN = RGB_MEAN
HHA_STD = RGB_STD
