"""The port's models: the shared transformer layers and, so far, the one
recsys model (BERT4Rec, with its cloze loss) with its candidate-retrieval
scorers and the sparse embedding ops."""
