"""PS applications (MF-SGD; LDA is ported in a later slice)."""
