"""Binary bag-of-words place recognition (replaces Thirdparty/DBoW2).

A k-branch, L-depth vocabulary over 256-bit ORB descriptors, trained by
hierarchical binary k-means (majority-bit medians).  Descriptor transform is
a batched tree descent (per level: gather k child centers, Hamming argmin as a
matmul); keyframe similarity is L1 scoring over tf-idf BoW vectors; the
inverted file is a dense (n_kf, n_words) matrix at this scale, so a whole-
database query is one matmul.
"""

from orb_slam3_study_kr_tpu.bow.vocabulary import (
    BinaryVocabulary, TreeVocabulary, train_vocabulary, load_dbow2_text,
    save_vocabulary, load_vocabulary)
from orb_slam3_study_kr_tpu.bow.database import KeyframeDatabase
