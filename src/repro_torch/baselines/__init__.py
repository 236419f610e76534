"""The paper's rival estimators: the sequential DirectLiNGAM baseline,
NOTEARS, GOLEM and ICA-LiNGAM."""
