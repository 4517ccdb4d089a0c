"""The training data: the file-glob dataset and its prefetching loader."""
