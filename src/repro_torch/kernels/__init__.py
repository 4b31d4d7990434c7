"""Hand-written Hopper kernels (``csrc/``), their wrappers, plain versions
(``ref``) and the dispatch (``ops``).  Nothing is built at import."""
