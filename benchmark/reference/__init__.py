"""The benchmark's plain reference: MolCLR's pretraining and fine-tuning
steps written from the published equations in plain PyTorch (f32, TF32
off), with frozen copies of the data arithmetic the port's steps follow
(the split, the tile-unit plan, the key draws, the augmentations). It
imports nothing of the program under test."""
