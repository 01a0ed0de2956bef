"""Per-dataset class-name tables and lookup (the port's own copy of
``rs_detection_tpu/config/constant.py``): DOTA v1/v1.5/v2, FAIR1M,
FAIR1M-1.5, SSDD and COCO class lists, name lookup, and the FAIR1M 37->10
class coarsening map."""

DOTA1_CLASSES = [
    'plane', 'baseball-diamond', 'bridge', 'ground-track-field',
    'small-vehicle', 'large-vehicle', 'ship', 'tennis-court',
    'basketball-court', 'storage-tank', 'soccer-ball-field',
    'roundabout', 'harbor', 'swimming-pool', 'helicopter',
]

DOTA1_5_CLASSES = DOTA1_CLASSES + ['container-crane']

DOTA2_CLASSES = DOTA1_5_CLASSES + ['airport', 'helipad']

FAIR_CLASSES = [
    'Boeing737', 'Boeing747', 'Boeing777', 'Boeing787', 'C919',
    'A220', 'A321', 'A330', 'A350', 'ARJ21', 'other-airplane',
    'Passenger Ship', 'Motorboat', 'Fishing Boat', 'Tugboat',
    'Engineering Ship', 'Liquid Cargo Ship', 'Dry Cargo Ship', 'Warship',
    'other-ship', 'Small Car', 'Bus', 'Cargo Truck', 'Dump Truck', 'Van',
    'Trailer', 'Tractor', 'Excavator', 'Truck Tractor', 'other-vehicle',
    'Basketball Court', 'Tennis Court', 'Football Field', 'Baseball Field',
    'Intersection', 'Roundabout', 'Bridge',
]

# Underscore variant used for submission files (constant.py:192).
FAIR_CLASSES_ = [c.replace(' ', '_') for c in FAIR_CLASSES]

FAIR1M_1_5_CLASSES = [
    'Airplane', 'Ship', 'Vehicle', 'Basketball_Court', 'Tennis_Court',
    'Football_Field', 'Baseball_Field', 'Intersection', 'Roundabout',
    'Bridge',
]

SSDD_CLASSES = ['ship']

COCO_CLASSES = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep',
    'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush',
]


def get_classes_by_name(name: str):
    """Look up a class table by dataset name (constant.py:207-224)."""
    tables = {
        'DOTA': DOTA1_CLASSES,
        'DOTA1': DOTA1_CLASSES,
        'DOTA1_5': DOTA1_5_CLASSES,
        'DOTA2': DOTA2_CLASSES,
        'FAIR': FAIR_CLASSES_,
        'FAIR1M_1_5': FAIR1M_1_5_CLASSES,
        'SSDD': SSDD_CLASSES,
        'SSDD+': SSDD_CLASSES,
        'COCO': COCO_CLASSES,
    }
    if name not in tables:
        raise KeyError(f"unknown dataset class table: {name}")
    return tables[name]


# FAIR1M2.0 fine classes -> FAIR1M-1.5 coarse classes (constant.py:226).
FAIR1M_MAPPING = {
    'A220': 'Airplane', 'A321': 'Airplane', 'A330': 'Airplane',
    'A350': 'Airplane', 'ARJ21': 'Airplane', 'Boeing737': 'Airplane',
    'Boeing747': 'Airplane', 'Boeing777': 'Airplane',
    'Boeing787': 'Airplane', 'C919': 'Airplane',
    'other-airplane': 'Airplane',
    'Tugboat': 'Ship', 'other-ship': 'Ship', 'Liquid_Cargo_Ship': 'Ship',
    'Motorboat': 'Ship', 'Passenger_Ship': 'Ship', 'Dry_Cargo_Ship': 'Ship',
    'Warship': 'Ship', 'Engineering_Ship': 'Ship', 'Fishing_Boat': 'Ship',
    'other-vehicle': 'Vehicle', 'Bus': 'Vehicle', 'Cargo_Truck': 'Vehicle',
    'Small_Car': 'Vehicle', 'Dump_Truck': 'Vehicle', 'Van': 'Vehicle',
    'Excavator': 'Vehicle', 'Tractor': 'Vehicle', 'Trailer': 'Vehicle',
    'Truck_Tractor': 'Vehicle',
    'Basketball_Court': 'Basketball_Court', 'Tennis_Court': 'Tennis_Court',
    'Football_Field': 'Football_Field', 'Baseball_Field': 'Baseball_Field',
    'Intersection': 'Intersection', 'Roundabout': 'Roundabout',
    'Bridge': 'Bridge',
}
