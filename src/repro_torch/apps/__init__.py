"""PS applications: MF-SGD (``matfact``) and LDA (``lda``)."""
