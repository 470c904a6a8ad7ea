"""Training (counterpart of ``repro.train``): AdamW and Adafactor applied in
place, int8 gradient compression with error feedback, the train step on
autograd, checkpoints in the reference's on-disk format, and the
straggler monitor."""
