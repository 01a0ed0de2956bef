"""Host-side data: image IO, transforms (the test pipeline's and the
training augmentations), collation, the tile dataset, the labelled
datasets with their VOC-style evaluation, and the tile-merge devkits.
Pillow is imported only by the modules that decode or transform images."""
