"""RNNoise-class denoiser (inference): ``model`` and the shipped weights
(``train.load_pretrained``)."""
