"""Models of the port: the CNN layers and VGG-16/19."""
