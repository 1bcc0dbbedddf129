"""Flash-forward variants: two heads per block (K9), all heads in one block
in three softmax modes (K10), and their benches against K1."""
