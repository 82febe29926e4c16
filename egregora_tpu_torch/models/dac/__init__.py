"""Descript Audio Codec (inference): ``model`` and the shipped compact
codecs (``train.load_pretrained``)."""
