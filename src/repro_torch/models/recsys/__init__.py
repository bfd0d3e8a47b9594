"""BERT4Rec and the candidate-retrieval scorers that serve it."""
