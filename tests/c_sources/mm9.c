/* matrixMultiply at 9x9: the shape of the reference's
 * tests/mm_common/mm.c (globals first and second, a results matrix, a
 * triple for, then the XOR of the product and an error count), with the
 * literal values of coast_tpu_torch/models/mm.py (_lcg_fill seeds 42 and
 * 43).  The XOR of a fault-free run is 3109119323. */
#include <stdio.h>

#define SIDE 9

unsigned int first[SIDE][SIDE] = {
    {19081, 17033, 15269, 25461, 13856, 1093, 13677, 26500, 20065},
    {23425, 5972, 16914, 18414, 8148, 30133, 3632, 21573, 10763},
    {6071, 21987, 30105, 4308, 13454, 27824, 13422, 1071, 18551},
    {26345, 4855, 29589, 15729, 14778, 23087, 27365, 25532, 20467},
    {7353, 21010, 30227, 8083, 2936, 31630, 9641, 3096, 30702},
    {11637, 27108, 8585, 8278, 4474, 4059, 29759, 8576, 14226},
    {17809, 12663, 10863, 5986, 7407, 11417, 19891, 15465, 17027},
    {30022, 3207, 2285, 25595, 16932, 30635, 15271, 607, 15465},
    {512, 9261, 11282, 30760, 24805, 12835, 23174, 9566, 5715}
};

unsigned int second[SIDE][SIDE] = {
    {3151, 1324, 15394, 20860, 8641, 22561, 20642, 14178, 24155},
    {19102, 29228, 2629, 21838, 10451, 8503, 28069, 14294, 5713},
    {15996, 29892, 3807, 1095, 10885, 14664, 25461, 20345, 20986},
    {16278, 492, 16895, 12971, 17640, 17363, 29891, 9564, 21300},
    {3225, 19640, 30804, 14013, 25853, 4058, 9892, 12661, 24887},
    {19946, 14392, 2073, 15848, 6375, 5791, 17675, 24514, 18763},
    {25242, 19694, 8695, 18955, 5734, 8452, 8035, 10316, 201},
    {27463, 25208, 25317, 25823, 12360, 10221, 13720, 19106, 17099},
    {8230, 23568, 19514, 21792, 23394, 2202, 27658, 17472, 19623}
};

unsigned int results[SIDE][SIDE];

unsigned int xor_golden = 3109119323u;

void matrix_multiply(unsigned int f_matrix[][SIDE],
                     unsigned int s_matrix[][SIDE],
                     unsigned int r_matrix[][SIDE]) {
    int i, j, k;
    for (i = 0; i < SIDE; i++) {
        for (j = 0; j < SIDE; j++) {
            for (k = 0; k < SIDE; k++) {
                r_matrix[i][j] += f_matrix[i][k] * s_matrix[k][j];
            }
        }
    }
}

int main() {
    int i, j;
    int errors = 0;
    unsigned int x = 0;
    matrix_multiply(first, second, results);
    for (i = 0; i < SIDE; i++) {
        for (j = 0; j < SIDE; j++) {
            x ^= results[i][j];
        }
    }
    if (x != xor_golden) {
        errors++;
    }
    printf("%u\n", x);
    printf("Number of errors: %d\n", errors);
    return 0;
}
