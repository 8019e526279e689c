"""Plain PyTorch and NumPy references of what the benchmark's cells run,
in float32 with TF32 off: a BERT encoder, an EfficientNet with its neck
and ArcFace head, an exact top-k with the job's filters, a character
tokenizer and AdamW. They import nothing of the program under test and
take nothing it made: weights are drawn again from the seed, inputs are
the benchmark's own."""
