"""Volume I/O, cropping and patch sampling."""
