"""PP-OCRv5 subtitle detection: the server DBNet (backbones, necks, heads,
dbnet), the video detector around it (detector) and the numpy/cv2 pre- and
post-processing (preprocess, postprocess, boxes)."""
