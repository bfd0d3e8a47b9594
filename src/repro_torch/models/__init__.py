"""The port's models: the shared transformer layers and, so far, the one
recsys model (BERT4Rec) with its candidate-retrieval scorers."""
