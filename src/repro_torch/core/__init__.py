"""Algorithm I: circuits, transforms, the fp64 back half and the explorer."""
