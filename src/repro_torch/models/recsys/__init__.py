"""BERT4Rec (serving and its cloze loss), the candidate-retrieval scorers
that serve it, and the sparse embedding ops."""
