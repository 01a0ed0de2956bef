"""Host-side data of the test task: image IO, transforms, collation, the
tile dataset and the tile-merge devkits. Pillow is imported only by the
modules that decode or transform images."""
